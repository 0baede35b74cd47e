"""PyTorch port vs JAX reference on the CPU: fixed mode, fusion mode without
unique edges, the volume's normal and cloud extraction, the copied umbrella
sensor model, and the port's bench entry.

The engines run on the tests/test_pipeline.py fixture (96x128 depth, 64^3
volume): fixed mode on its three-sphere scene with the big sphere moving
5 mm per frame (the camera is static, and the three spheres constrain its
ICP), fusion mode on the big sphere alone moving 4 mm per frame. Stepwise:
after each JAX frame its state is loaded into the port (utils/convert.py)
and the port's next frame is held against JAX's. JAX's k-NN runs its TPU
kernel in interpret mode (test_torch_fusion._jax_knn_through_pallas: the
port forms its distances the same way); JAX's fixed mode runs as shipped,
with the integrate and raycast formulations its dispatch picks (the port
picks the same). The JAX engine runs start together with the module's
first test, each in a process of its own (test_torch_fusion.module_refs)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import se3 as jse3
from dynfu_tpu.engine.dynfusion import DynFusion as JaxDynFusion
from dynfu_tpu.io import kinect_sim as jsim
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu_torch import bench
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.io import kinect_sim
from dynfu_tpu_torch.utils import benchmarks, convert
from dynfu_tpu_torch.volume import tsdf as tv
from dynfu_tpu_torch.warp import field as tfield

from test_pipeline import (CENTER, RADIUS, SCENE, scene_depth,
                           small_dynfu_params, sphere_depth)
from test_torch_fusion import _jax_knn_through_pallas, module_refs

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

FIXED_FRAMES = [scene_depth(spheres=[((CENTER[0] + 0.005 * i, CENTER[1],
                                       CENTER[2]), RADIUS)] + SCENE[1:])
                for i in range(3)]
SPHERE_FRAMES = [sphere_depth((CENTER[0] + 0.004 * i, CENTER[1], CENTER[2]),
                              RADIUS) for i in range(2)]


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _equal_nan(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=atol)


# --- the copied sensor model -------------------------------------------------


@pytest.mark.parametrize("i", [0, 5, 11])
def test_umbrella_frame_equals_jax(i):
    """io/kinect_sim is a copy: the same frame, byte for byte."""
    got, want = kinect_sim.umbrella_frame(i), jsim.umbrella_frame(i)
    assert got.dtype == want.dtype and got.shape == (480, 640)
    assert got.tobytes() == want.tobytes()
    assert (got > 0).mean() > 0.5


# --- fixed mode ------------------------------------------------------------


def _fixed_params(rotations=False):
    return dataclasses.replace(small_dynfu_params(),
                               solver_rotations=rotations)


_ENGINE_STATE = ("vol", "warpfield", "canonical", "canonical_warped",
                 "soup_inverse", "soup_mask", "canonical_mult", "prev_pyr",
                 "frame_counter")


def _state(e):
    """The JAX engine's state as numpy arrays, for utils/convert."""
    c = e.canonical
    st = dict(
        vol=tuple(np.array(a) for a in e.vol),
        wf=tuple(np.array(a) for a in e.warpfield),
        canonical=(c.idx, np.array(c.vertices), np.array(c.normals),
                   np.array(c.mask)),
        frame_counter=e.frame_counter,
        poses=[(np.array(R), np.array(t)) for R, t in e.poses])
    if e.soup_inverse is not None:
        st.update(soup_inverse=np.array(e.soup_inverse),
                  soup_mask=np.array(e.soup_mask),
                  canonical_mult=np.array(e.canonical_mult))
    if getattr(e, "prev_pyr", None) is not None:
        st["prev_pyr"] = [(np.array(p), np.array(n)) for p, n in e.prev_pyr]
    return st


def _outputs(e, to_np):
    """After a frame: the pose, the counters and node count, the live set,
    the warped canonical (pre-solve warp), the canonical through the frame's
    final field (warped by the port's DQB warp for both engines, so the
    solved fields are compared in meters) and the node positions."""
    v, m = e.warped_cloud(unique=True)
    wf = convert.warpfield(*(to_np(a) for a in e.warpfield), device="cpu")
    c = torch.as_tensor(to_np(e.canonical.vertices))
    post, _ = tfield.warp_points_normals(wf, c, c)
    fs = e.last_frame_stats
    live = e.live
    return dict(
        pose=tuple(np.asarray(a) for a in e.poses[-1]),
        stats=None if fs is None else (int(fs.mc_dropped),
                                       int(fs.corr_dropped)),
        count=int(e.warpfield.count), node_pos=to_np(e.warpfield.pos),
        warped=to_np(v), mask=to_np(m), post=post.numpy(),
        live=None if live is None else (to_np(live.vertices),
                                        to_np(live.normals),
                                        to_np(live.mask)),
        canonical=(to_np(e.canonical.vertices), to_np(e.canonical.normals)),
        tsdf=to_np(e.vol.tsdf))


def _pin_dg_w(e):
    """Frame 0 leaves a weakly typed dg_w array and a later frame a strongly
    typed one: the same values, but a second compile of the frame program.
    Pin the type once."""
    wf = e.warpfield
    e.warpfield = wf._replace(w=jnp.asarray(np.array(wf.w)))


def _jax_fixed(params):
    """JAX's fixed-mode engine as shipped."""
    return JaxDynFusion(params, mode="fixed")


def _jax_fixed_run():
    """JAX in fixed mode (_jax_fixed) over FIXED_FRAMES, with the
    translations solve: (state before frame i, outputs after frame i)."""
    with _jax_knn_through_pallas():
        eng = _jax_fixed(_fixed_params())
        states, outs = [], []
        for d in FIXED_FRAMES:
            states.append(_state(eng) if eng.frame_counter else None)
            eng(d)
            outs.append(_outputs(eng, np.array))
            _pin_dg_w(eng)
    return states, outs


def _jax_fixed_se3_frame1():
    """The outputs of JAX's fixed-mode frame 1 with solver_rotations=True
    from the translations run's state after frame 0 (frame 0 does not
    depend on the solver)."""
    with _jax_knn_through_pallas():
        eng = _jax_fixed(_fixed_params())
        eng(FIXED_FRAMES[0])
        _pin_dg_w(eng)
        se3_eng = _jax_fixed(_fixed_params(True))
        for a in _ENGINE_STATE + ("poses",):
            setattr(se3_eng, a, getattr(eng, a))
        se3_eng(FIXED_FRAMES[1])
        return _outputs(se3_eng, np.array)


@pytest.fixture(scope="module", autouse=True)
def jax_refs(request):
    """The module's JAX engine runs (module_refs): fixed mode's run and its
    SE(3) frame, fusion mode's soup frames."""
    refs = module_refs(request, {"fixed": _jax_fixed_run,
                                 "fixed_se3": _jax_fixed_se3_frame1,
                                 "soup": _jax_fusion_soup_frames})
    yield refs
    refs.close()


@pytest.fixture(scope="module")
def jax_fixed_run(jax_refs):
    """JAX in fixed mode: (state before frame i, outputs after frame i) of
    the translations run, and frame 1's outputs with the SE(3) solve."""
    return jax_refs["fixed"] + (jax_refs["fixed_se3"],)


def _port(params, mode):
    return DynFusion(convert.params(params), device="cpu", mode=mode)


def _port_outputs(e):
    return _outputs(e, lambda t: t.cpu().numpy())


def test_fixed_frame0_matches(jax_fixed_run):
    """Bootstrap in fixed mode: the same canonical (dedup order included),
    its TSDF-gradient normals (extract_normals in the volume frame) within
    1e-5 with NaN at the same vertices, and the same nodes."""
    _, outs, _ = jax_fixed_run
    port = _port(_fixed_params(), "fixed")
    assert port(FIXED_FRAMES[0]) is False
    got, want = _port_outputs(port), outs[0]
    assert got["count"] == want["count"] > 3
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["canonical"][0], want["canonical"][0])
    _equal_nan(got["canonical"][1], want["canonical"][1], 1e-5)
    assert np.isfinite(want["canonical"][1][want["mask"]]).all()
    np.testing.assert_array_equal(got["node_pos"], want["node_pos"])


@pytest.mark.parametrize("k,rotations", [
    pytest.param(1, False, id="1"),
    pytest.param(2, False, id="2"),
    pytest.param(1, True, id="se3-1"),
])
def test_fixed_frame_from_jax_state(jax_fixed_run, k, rotations):
    """Frame k of fixed mode from JAX's state after frame k-1 (frame 2's
    pose comes from the gather ICP against JAX's raycast pyramid): the pose
    within 1e-4, the same drop counters and node count, the live soup, the
    warped canonical, the canonical through the solved and grown field and
    the node positions within 1e-4 m, the live normals as _hold_normals
    holds them. With rotations, frame 1 runs the DLB warp, the SE(3) solve
    and DLB node insertion.

    Frame 2's pose is tilted: both engines integrate it through the
    rotation homography (integrate_rotated) and raycast it through the
    rotated sweep. The port's ICP pose differs from JAX's by float32
    roundoff (2.4e-6), which moves the homography's nearest pixel at a few
    pixels and the live soup with it (9 of its vertices). So frame 2's
    outputs are held on a second run of the frame whose ICP increment is
    JAX's: its volume is then JAX's bit for bit."""
    states, outs, se3_out = jax_fixed_run
    want = se3_out if rotations else outs[k]
    params = _fixed_params(rotations)
    port = convert.load_engine_state(_port(params, "fixed"), **states[k])
    assert port(FIXED_FRAMES[k]) is True
    got = _port_outputs(port)
    for a, b in zip(got["pose"], want["pose"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert got["stats"] == want["stats"]
    assert got["count"] == want["count"]
    if k == 2:
        assert np.abs(want["pose"][1]).max() > 1e-3  # the ICP moved it
        # JAX's increment (the pose before it is the identity)
        np.testing.assert_array_equal(states[k]["poses"][-1][0], np.eye(3))
        np.testing.assert_array_equal(states[k]["poses"][-1][1], 0.0)
        packed = np.concatenate([want["pose"][0].reshape(-1),
                                 want["pose"][1], [1.0]]).astype(np.float32)
        port = convert.load_engine_state(_port(params, "fixed"),
                                         **states[k])
        port._track_gather = lambda curr, prev: packed
        port(FIXED_FRAMES[k])
        got = _port_outputs(port)
        np.testing.assert_array_equal(got["tsdf"], want["tsdf"])
        assert got["stats"] == want["stats"]
        assert got["count"] == want["count"]
    lm, m, n = want["live"][2], want["mask"], want["count"]
    assert lm.sum() > 500 and m.sum() > 500
    np.testing.assert_array_equal(got["live"][2], lm)
    np.testing.assert_array_equal(got["mask"], m)
    for key, sel in (("warped", m), ("post", m), ("node_pos", slice(n))):
        np.testing.assert_allclose(got[key][sel], want[key][sel], rtol=0,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["live"][0][lm], want["live"][0][lm],
                               rtol=0, atol=1e-4)
    # the ICP reference for the next frame: the raycast of the new model
    assert port.prev_pyr is not None and len(port.prev_pyr) == port.levels
    _hold_normals(got, want)


def _hold_normals(got, want):
    """The live normals: NaN at the same vertices, and within 1e-4 wherever
    the TSDF the gradient samples (two voxels around the vertex) is the
    same. A float16 ulp of one voxel moves the normals sampled beside it by
    up to ~5e-4; such voxels must be few (< 0.05 % of the volume), and the
    vertices held at least 90 % of the live set."""
    lm = want["live"][2]
    gn, wn = got["live"][1][lm], want["live"][1][lm]
    np.testing.assert_array_equal(np.isnan(gn), np.isnan(wn))
    diff = torch.as_tensor(got["tsdf"] != want["tsdf"])
    assert diff.float().mean() < 5e-4
    near = torch.nn.functional.max_pool3d(
        diff[None, None].float(), 5, stride=1, padding=2)[0, 0].bool()
    vox = np.clip(np.floor(want["live"][0][lm] * 64).astype(int), 0, 63)
    same = ~near.numpy()[vox[:, 0], vox[:, 1], vox[:, 2]]
    assert same.mean() >= 0.9
    _equal_nan(gn[same], wn[same], 1e-4)


# --- the volume's normal and cloud extraction -----------------------------


def _rotated_volume(jax_fixed_run):
    """The fixed run's volume after frame 0, posed with a rotation (so that
    the world frame differs from the volume frame), for both packages."""
    tsdf, weight, _, t = jax_fixed_run[0][1]["vol"]
    R, _ = jse3.from_rodrigues(jnp.asarray([0.3, -0.2, 0.1], jnp.float32),
                               jnp.zeros(3, jnp.float32))
    R = np.array(R)
    jvol = jtv.TsdfVolume(jnp.asarray(tsdf), jnp.asarray(weight),
                          jnp.asarray(R), jnp.asarray(t))
    return jvol, convert.volume(tsdf, weight, R, t, device="cpu")


@pytest.mark.parametrize("frame", ["world", "volume"])
def test_extract_normals_matches_jax(jax_fixed_run, frame):
    """extract_normals at the canonical vertices and at points near the
    volume's faces (outside [2, dims - 2)^3: NaN): NaN at the same points,
    the values within 1e-5."""
    jvol, tvol = _rotated_volume(jax_fixed_run)
    cfg = jtv.TsdfConfig(dims=(64,) * 3, size=(1.0,) * 3, trunc_dist=0.03)
    idx, verts, _, mask = jax_fixed_run[0][1]["canonical"]
    vs = 1.0 / 64
    edge = np.array([[1.4, 30, 30], [1.6, 30, 30], [30, 61.4, 30],
                     [30, 30, 61.6]], np.float32) * vs
    pts = np.concatenate([verts[mask], edge]).astype(np.float32)
    if frame == "world":
        pts = pts @ np.array(jvol.pose_r).T + np.array(jvol.pose_t)
    want = jtv.extract_normals(jvol, jnp.asarray(pts), cfg, frame=frame)
    got = tv.extract_normals(tvol, _t(pts), _tsdf_config(cfg), frame=frame)
    _equal_nan(got, want, 1e-5)
    n = mask.sum()
    assert np.isnan(np.asarray(want)[n:]).all()
    assert np.isfinite(np.asarray(want)[:n]).all(1).mean() > 0.99


def _tsdf_config(cfg):
    return tv.TsdfConfig(dims=cfg.dims, size=cfg.size,
                         trunc_dist=cfg.trunc_dist,
                         max_weight=cfg.max_weight,
                         raycast_step_factor=cfg.raycast_step_factor,
                         gradient_delta_factor=cfg.gradient_delta_factor)


def test_extract_cloud_matches_jax(jax_fixed_run):
    """extract_cloud with a capacity below the crossing count: the same
    first `capacity` crossings (x edges, then y, then z) and mask, the
    world-frame points within 1e-5."""
    jvol, tvol = _rotated_volume(jax_fixed_run)
    cfg = jtv.TsdfConfig(dims=(64,) * 3, size=(1.0,) * 3, trunc_dist=0.03)
    cap = 1024
    wp, wm = jtv.extract_cloud(jvol, cfg, capacity=cap)
    gp, gm = tv.extract_cloud(tvol, _tsdf_config(cfg), capacity=cap)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert np.asarray(wm).all()  # the crossings outnumber the capacity
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0,
                               atol=1e-5)
    big = jtv.extract_cloud(jvol, cfg, capacity=1 << 12)[1]
    got = tv.extract_cloud(tvol, _tsdf_config(cfg), capacity=1 << 12)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(big))
    assert cap < np.asarray(big).sum() < 1 << 12


# --- fusion mode without unique edges --------------------------------------


def _fusion_soup_params():
    """Fusion mode on the fixture with the translations solve, the
    canonical being the marching-cubes soup with extract_normals (no
    corr_unique_edges)."""
    return dataclasses.replace(small_dynfu_params(), max_nodes=128,
                               fusion_max_active=1 << 14)


def _jax_fusion_soup_frames():
    """JAX's fusion mode without unique edges over SPHERE_FRAMES[:2] (its
    k-NN through its TPU kernel): the state after frame 0 and frame 1's
    counters, node count and positions, canonical (mask, vertices,
    normals) and warped canonical."""
    with _jax_knn_through_pallas():
        eng = JaxDynFusion(_fusion_soup_params(), mode="fusion")
        eng(SPHERE_FRAMES[0])
        _pin_dg_w(eng)
        st = _state(eng)
        eng(SPHERE_FRAMES[1])
    fs = eng.last_frame_stats
    return st, dict(
        mc_dropped=int(fs.mc_dropped), corr_dropped=int(fs.corr_dropped),
        n_band=int(fs.band.n_band), n_captured=int(fs.band.n_captured),
        count=int(eng.warpfield.count), pos=np.array(eng.warpfield.pos),
        mask=np.array(eng.canonical.mask),
        vertices=np.array(eng.canonical.vertices),
        normals=np.array(eng.canonical.normals),
        warped=np.array(eng.canonical_warped.vertices))


def test_fusion_soup_frame_from_jax_state(jax_refs):
    """Frame 1 of fusion mode without unique edges from JAX's state after
    frame 0 (whose canonical is the corner-convention soup with
    TSDF-gradient normals): the same counters (drops, band) and node count,
    the same canonical mask, the re-extracted canonical, its normals, the
    warped canonical and the node positions within 1e-4 m; the soup is the
    frame's, so mesh() runs no marching cubes."""
    st, j = jax_refs["soup"]
    port = convert.load_engine_state(_port(_fusion_soup_params(), "fusion"),
                                     **st)
    assert port(SPHERE_FRAMES[1]) is True
    fs = port.last_frame_stats
    for a in ("mc_dropped", "corr_dropped"):
        assert int(getattr(fs, a)) == j[a]
    for a in ("n_band", "n_captured"):
        assert int(getattr(fs.band, a)) == j[a] > 0
    assert int(port.warpfield.count) == j["count"]
    m = j["mask"]
    np.testing.assert_array_equal(port.canonical.mask.numpy(), m)
    assert m.sum() > 500
    pairs = ((port.canonical.vertices, j["vertices"]),
             (port.canonical_warped.vertices, j["warped"]))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy()[m], b[m], rtol=0, atol=1e-4)
    _equal_nan(port.canonical.normals.numpy()[m], j["normals"][m], 1e-4)
    n = j["count"]
    np.testing.assert_allclose(port.warpfield.pos.numpy()[:n], j["pos"][:n],
                               rtol=0, atol=1e-4)
    verts, count = port.mesh()
    assert verts is port.canonical.vertices and int(count) == m.sum()


# --- the bench entry ---------------------------------------------------------


def test_bench_entry_prints_the_four_keys(monkeypatch, capsys):
    """python -m dynfu_tpu_torch.bench, with the benchmarks stubbed: one
    stdout line with bench.py's four keys from run_benchmark(512), then
    three `# detail:` lines on stderr (512^3, 128^3, SE(3) fusion 512^3);
    DYNFU_BENCH_DIMS sets the headline's dims and drops the details; a
    failing detail row fails the entry."""
    calls = []

    def stub(name, fail=False):
        def run(**kw):
            calls.append((name, kw))
            if fail:
                raise RuntimeError("fusion failed")
            return {"metric": f"{name}_{kw['volume_dims']}", "value": 2.0,
                    "unit": "frames/s", "vs_baseline": 2.0 / 30,
                    "frame_ms": 500.0}
        return run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(benchmarks, "run_benchmark", stub("parity"))
    monkeypatch.setattr(benchmarks, "run_fusion_benchmark", stub("fusion"))
    monkeypatch.delenv("DYNFU_BENCH_DIMS", raising=False)
    assert bench.main() == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"metric": "parity_512", "value": 2.0,
                                    "unit": "frames/s",
                                    "vs_baseline": 2.0 / 30}
    details = [json.loads(x[len("# detail: "):]) for x in err.splitlines()
               if x.startswith("# detail: ")]
    assert [d["metric"] for d in details] == ["parity_512", "parity_128",
                                              "fusion_512"]
    assert calls[2] == ("fusion", {"volume_dims": 512, "rotations": True})

    calls.clear()
    monkeypatch.setenv("DYNFU_BENCH_DIMS", "128")
    assert bench.main() == 0
    assert calls == [("parity", {"volume_dims": 128})]
    capsys.readouterr()

    monkeypatch.delenv("DYNFU_BENCH_DIMS")
    monkeypatch.setattr(benchmarks, "run_fusion_benchmark",
                        stub("fusion", fail=True))
    with pytest.raises(RuntimeError, match="fusion failed"):
        bench.main()
