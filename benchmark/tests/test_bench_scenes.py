"""The traffic generator: every mix repeats per seed, is cyclic, and keeps
its surface in the camera's view."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH

from dfbench import scenes

CAMERA = {"rows": 480, "cols": 640, "fx": 525.0, "fy": 525.0}
MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_mix_repeats_per_seed_and_is_cyclic(name):
    m = mix(name)
    a = scenes.make(m, CAMERA, 2 ** 31 + 5, "cpu")
    b = scenes.make(m, CAMERA, 2 ** 31 + 5, "cpu")
    assert (a.start, a.step) == (b.start, b.step)
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    P = scenes.period_of(m)
    assert a.period == P
    for k in (0, 1, P - 1):
        assert np.array_equal(a.depth(k), a.depth(k + P))
    # every seed: the same frames from the same first frame, in one of
    # two directions
    steps = set()
    for seed in range(8):
        c = scenes.make(m, CAMERA, seed, "cpu")
        assert all(np.array_equal(x, y) for x, y in zip(a.frames, c.frames))
        assert c.start == a.start
        steps.add(c.step)
    assert steps == {1, -1}


def test_sphere_breathe_stays_in_view():
    m = mix("sphere_breathe")
    f = scenes.make(m, CAMERA, 7, "cpu")
    assert f.period == m["radius_period"]
    for d in f.frames:
        hit = d > 0
        # the whole silhouette inside the image: no border pixel hit
        assert hit.sum() > 50_000
        assert not (hit[0].any() or hit[-1].any() or hit[:, 0].any()
                    or hit[:, -1].any())
    r = [t["radius"] for t in f.truth]
    assert min(r) == pytest.approx(0.49) and max(r) == pytest.approx(0.51)
    # it breathes: the nearest point comes and goes by the radius
    near = [d[d > 0].min() for d in f.frames]
    assert max(near) - min(near) >= 19
    assert f.truth[f.index(0)]["radius"] == pytest.approx(0.5)


def test_spheres_orbit_keeps_every_sphere_in_view():
    m = mix("spheres_orbit")
    P = scenes.period_of(m)
    for j in range(0, P, 5):
        cam = scenes.triangle(np.array([j]), m["camera_leg"],
                              m["camera_center"])[0] * np.asarray(
                                  m["camera_step"])
        for c, r in m["spheres"]:
            rel = np.asarray(c) - cam
            # nearer than the sensor's far limit, beyond its near limit
            assert 0.4 < rel[2] - r and rel[2] + r < 4.0
            # its centre projects inside the image
            u = 525.0 * rel[0] / rel[2] + 319.5
            v = 525.0 * rel[1] / rel[2] + 239.5
            assert 0 <= u < 640 and 0 <= v < 480


def test_umbrella_frames_are_the_same_set_for_every_seed():
    m = mix("umbrella_full")
    a = scenes.make(m, CAMERA, 1, "cpu")
    b = scenes.make(m, CAMERA, 2 ** 33 + 2, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    assert not np.array_equal(a.frames[0], a.frames[1])  # it breathes
    for d in a.frames:
        assert (d > 0).mean() > 0.5  # wall, floor and canopy in view


def test_sphere_depth_matches_the_ports_generator():
    """The generator's sphere equals io/datasets.sphere_depth (the port's,
    numpy) pixel for pixel, but for rounding at a truncated mm."""
    from dynfu_tpu_torch.io.datasets import sphere_depth

    want = sphere_depth((0.1, 0.0, 1.5), 0.5, 480, 640, 525.0, 525.0,
                        319.5, 239.5)
    got = scenes.sphere_depth(
        torch.tensor([[0.1, 0.0, 1.5]], dtype=torch.float64), 0.5,
        torch.zeros((1, 3), dtype=torch.float64), 480, 640, 525.0, 525.0,
        319.5, 239.5)[0].numpy()
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() < 1e-3
