"""engine frame loop: host syncs per frame, as torch's sync debug mode
("warn") reports them over the sync-counted frames (the port's
utils/rigid_profile.count_syncs)."""


def read(run):
    return run.syncs / run.sync_frames if run.sync_frames else None
