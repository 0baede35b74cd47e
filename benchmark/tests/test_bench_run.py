"""Whole runs on the CPU at a small size, the look for a card skipped:
the unbroken program is correct; the control and each fault the cells can
have come out not correct; a configuration, a mix and a metric added only
as files are found. The CPU has no CUDA kernel, so the program takes its
plain versions here and equals the reference bit for bit."""

import json
import shutil
import time

import pytest
import torch

from conftest import BENCH, tiny_bench

from dfbench import loop

PARITY, RIGID = "parity512.sphere_breathe", "rigid512.spheres_orbit"
SEED = 2 ** 31 + 11


@pytest.fixture
def bench(tmp_path, monkeypatch):
    # one checked frame, the first after the set-up frames
    monkeypatch.setattr(loop, "CHECK_FROM", 1)
    monkeypatch.setattr(loop, "CHECKED", 1)
    return tiny_bench(tmp_path)


def run(bench, cell, **kw):
    return loop.run_cell(bench, cell, SEED, 0.1, False, "cpu", time.time(),
                         log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", [PARITY, RIGID])
def test_program_is_correct_and_the_control_is_not(bench, cell):
    res = run(bench, cell, control=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"fps", "frame_ms_p95", "peak_mem_gib",
                                   "setup_s"}
    limits = loop.cell_files(bench, cell)[1]["limits"]
    ok, rows = loop.check.judge(res["control"], limits)
    assert not ok, rows


def _solve_keeps_state(monkeypatch):
    from dynfu_tpu_torch.solver import gn

    orig = gn.solve

    def solve(wf, *a, **kw):
        return wf, orig(wf, *a, **kw)[1]
    monkeypatch.setattr(gn, "solve", solve)


def _half_of_the_rows(monkeypatch):
    from dynfu_tpu_torch.ops import knn

    orig = knn.nn1_gather_xwindow

    def corr(*a, **kw):
        vals, exact = orig(*a, **kw)
        n = int(a[4].sum())  # the live rows lead the buffer
        exact = exact.clone()
        exact[n // 2:] = False
        return vals, exact
    monkeypatch.setattr(knn, "nn1_gather_xwindow", corr)


def _warp_altered(monkeypatch):
    from dynfu_tpu_torch.warp import field

    orig = field.warp_points_normals

    def warp(*a, **kw):
        wv, wn = orig(*a, **kw)
        return wv + 1e-3, wn
    monkeypatch.setattr(field, "warp_points_normals", warp)


def _insertion_skipped(monkeypatch):
    from dynfu_tpu_torch.warp import field

    monkeypatch.setattr(field, "update_warpfield", lambda wf, *a, **kw: wf)


def _pose_kept(monkeypatch):
    from dynfu_tpu_torch.engine.kinfu import KinFu

    monkeypatch.setattr(KinFu, "_push_pose",
                        lambda self, packed: self.poses.append(self.poses[-1]))


def _half_of_the_image(monkeypatch):
    from dynfu_tpu_torch.ops import imgproc

    orig = imgproc.compute_dists

    def dists(*a, **kw):
        d = orig(*a, **kw).clone()
        d[:, d.shape[1] // 2:] = 0
        return d
    monkeypatch.setattr(imgproc, "compute_dists", dists)


def _raycast_altered(monkeypatch):
    from dynfu_tpu_torch.engine.kinfu import KinFu

    orig = KinFu._raycast

    def raycast(self, pose):
        pts, nrm = orig(self, pose)
        return pts + 1e-3, nrm
    monkeypatch.setattr(KinFu, "_raycast", raycast)


@pytest.mark.parametrize("cell,fault", [
    (PARITY, _solve_keeps_state), (PARITY, _half_of_the_rows),
    (PARITY, _warp_altered), (PARITY, _insertion_skipped),
    (RIGID, _pose_kept),
    (RIGID, _half_of_the_image), (RIGID, _raycast_altered)],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(bench, cell)
    assert not res["correct"], res["checks"]


def test_files_alone_add_a_configuration_a_mix_and_a_metric(
        bench, tmp_path, monkeypatch):
    """A new configuration file, mix file and metric reader, named only in
    BENCHMARK.json, make a cell that runs and reports the new metric."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH / "traffic", root / "traffic")
    shutil.copytree(BENCH / "metrics", root / "metrics")
    monkeypatch.setattr(loop, "BENCH_DIR", root)
    conf = json.loads(open(next(c["file"] for c in bench["configs"]
                                if c["name"] == "kinfu_rigid_512")).read())
    conf["kinfu"]["volume_dims"] = [96, 96, 96]
    (tmp_path / "kinfu_new.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / "spheres_orbit.json").read_text())
    mix["camera_leg"] = 10
    (root / "traffic" / "orbit_short.json").write_text(json.dumps(mix))
    (root / "metrics" / "frames_profiled.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    bench["configs"].append({"name": "kinfu_new", "source": "test",
                             "file": str(tmp_path / "kinfu_new.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new.cell", "config": "kinfu_new",
                               "traffic": "orbit_short", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_profiled", "unit": "frames",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine frame loop", "moves": "fps",
                               "workloads": ["new.cell"]})
    res = loop.run_cell(bench, "new.cell", SEED, 0.1, True, "cpu",
                        time.time(), log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_profiled"]["value"] == loop.PROFILED
    assert "stage_ms.icp" not in res["metrics"]  # not listed for new.cell


@pytest.mark.cuda
def test_control_on_the_card(cuda_device, tmp_path, monkeypatch):
    """The control at this small size on the card: the program correct,
    the control not."""
    monkeypatch.setattr(loop, "CHECK_FROM", 1)
    monkeypatch.setattr(loop, "CHECKED", 1)
    b = tiny_bench(tmp_path)
    for cell in (PARITY, RIGID):
        res = loop.run_cell(b, cell, SEED, 0.1, False, cuda_device,
                            time.time(), log=lambda m: None, control=True)
        limits = loop.cell_files(b, cell)[1]["limits"]
        assert res["correct"], res["checks"]
        assert not loop.check.judge(res["control"], limits)[0]
    torch.cuda.empty_cache()
