"""PyTorch port vs JAX reference: the parity DynFusion frame loop on the
tests/test_pipeline.py fixture (96x128 depth, 64^3 volume, a sphere of
r = 0.22 m moving 5 mm per frame), frame 0 and two tracked frames.

Stepwise: after each JAX frame its state is loaded into the port
(utils/convert.py) and the port's next frame is held against JAX's. Free
running: the port runs all three frames on its own."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.engine.dynfusion import DynFusion as JaxDynFusion
from dynfu_tpu.engine.dynfusion import Frame as JFrame
from dynfu_tpu.volume.tsdf import TsdfVolume as JVolume
from dynfu_tpu.warp.field import WarpField as JWarpField
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.utils import convert
from dynfu_tpu_torch.warp import field as tfield

from test_pipeline import CENTER, RADIUS, small_dynfu_params, sphere_depth

FRAMES = [sphere_depth((CENTER[0] + 0.005 * i, CENTER[1], CENTER[2]),
                       RADIUS) for i in range(3)]

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)


def _state(e):
    """The JAX engine's state as numpy arrays, for utils/convert."""
    return dict(
        vol=tuple(np.array(a) for a in e.vol),
        wf=tuple(np.array(a) for a in e.warpfield),
        canonical=(e.canonical.idx, np.array(e.canonical.vertices),
                   np.array(e.canonical.normals), np.array(e.canonical.mask)),
        soup_inverse=np.array(e.soup_inverse),
        soup_mask=np.array(e.soup_mask),
        canonical_mult=np.array(e.canonical_mult),
        frame_counter=e.frame_counter,
        poses=[(np.array(R), np.array(t)) for R, t in e.poses])


def _outputs(e, to_np):
    """Per-frame observables: the warped cloud (pre-solve warp), the
    canonical through the frame's final field (warped by the port's warp
    for both engines, so the solved fields are compared in meters), the
    node count and positions, the drop counters."""
    v, m = e.warped_cloud(unique=True)
    wf = convert.warpfield(*(to_np(a) for a in e.warpfield), device="cpu")
    c = torch.as_tensor(to_np(e.canonical.vertices))
    post, _ = tfield.warp_points_normals(wf, c, c)
    fs = e.last_frame_stats
    return dict(
        warped=to_np(v), mask=to_np(m), post=post.numpy(),
        count=int(e.warpfield.count), node_pos=to_np(e.warpfield.pos),
        mc_dropped=None if fs is None else int(fs.mc_dropped),
        corr_dropped=None if fs is None else int(fs.corr_dropped))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX run: (state before frame i, outputs after frame i)."""
    eng = JaxDynFusion(small_dynfu_params())
    states, outs = [], []
    for d in FRAMES:
        states.append(_state(eng) if eng.frame_counter else None)
        eng(d)
        outs.append(_outputs(eng, np.array))
        # frame 0 leaves a weakly typed dg_w array, and a later frame a
        # strongly typed one: the same values, but a second compile of the
        # whole frame program (~8 s here). Pin the type once.
        wf = eng.warpfield
        eng.warpfield = wf._replace(w=jnp.asarray(np.array(wf.w)))
    return states, outs


def _port_outputs(e):
    return _outputs(e, lambda t: t.cpu().numpy())


def _port(jax_params=None):
    return DynFusion(convert.params(jax_params or small_dynfu_params()),
                     device="cpu")


def test_frame0_matches(jax_run):
    """Bootstrap: the same canonical (dedup order included) and nodes."""
    _, outs = jax_run
    port = _port()
    assert port(FRAMES[0]) is False
    got, want = _port_outputs(port), outs[0]
    assert got["count"] == want["count"] > 3
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["warped"], want["warped"])
    np.testing.assert_array_equal(got["node_pos"], want["node_pos"])


@pytest.mark.parametrize("k", [1, 2])
def test_tracked_frame_from_jax_state(jax_run, k):
    """Frame k from JAX's state after frame k-1: the same drop counters
    and node count; the warped cloud, and the canonical through the
    solved and grown field, within 1e-4 m (float32 roundoff through the
    solve; the selections are equal)."""
    states, outs = jax_run
    port = convert.load_engine_state(_port(), **states[k])
    assert port(FRAMES[k]) is True
    got, want = _port_outputs(port), outs[k]
    assert got["mc_dropped"] == want["mc_dropped"] == 0
    assert got["corr_dropped"] == want["corr_dropped"] == 0
    assert got["count"] == want["count"]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    np.testing.assert_allclose(got["warped"][m], want["warped"][m], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["post"][m], want["post"][m], rtol=0,
                               atol=1e-4)


def test_free_running_three_frames(jax_run):
    """The port alone over all three frames: the same node count, and the
    final warped canonical within 1e-3 m of JAX's (roundoff compounds
    through two solves and their Tukey cutoffs)."""
    _, outs = jax_run
    port = _port()
    for d in FRAMES:
        port(d)
    got, want = _port_outputs(port), outs[-1]
    assert got["count"] == want["count"]
    assert got["corr_dropped"] == want["corr_dropped"] == 0
    m = want["mask"]
    np.testing.assert_array_equal(got["mask"], m)
    assert torch.isfinite(torch.as_tensor(got["post"][m])).all()
    np.testing.assert_allclose(got["post"][m], want["post"][m], rtol=0,
                               atol=1e-3)


def _load_jax(e, st):
    """Install a _state() snapshot into the JAX engine `e`."""
    e.vol = JVolume(*(jnp.asarray(a) for a in st["vol"]))
    e.warpfield = JWarpField(*(jnp.asarray(a) for a in st["wf"]))
    idx, v, n, m = st["canonical"]
    e.canonical = JFrame(idx, jnp.asarray(v), jnp.asarray(n), jnp.asarray(m))
    e.canonical_warped = e.canonical
    for k in ("soup_inverse", "soup_mask", "canonical_mult"):
        setattr(e, k, jnp.asarray(st[k]))
    e.frame_counter = st["frame_counter"]
    e.poses = list(st["poses"])
    return e


def test_unique_edge_frame_from_jax_state(jax_run):
    """Frame 1 with corr_unique_edges (the >= 384^3 preset's live set: the
    unique isosurface edge vertices instead of the marching-cubes soup) from
    JAX's state after frame 0: the live set equal index for index, the same
    counters and node count, the soup left to mesh() on demand, the warped
    cloud within 1e-4 m as in the test above."""
    states, _ = jax_run
    params = dataclasses.replace(small_dynfu_params(), corr_unique_edges=True,
                                 max_edge_verts=1 << 13, edge_col_budget=8)
    jax_eng = _load_jax(JaxDynFusion(params), states[1])
    jax_eng(FRAMES[1])
    port = convert.load_engine_state(_port(params), **states[1])
    assert port(FRAMES[1]) is True
    np.testing.assert_array_equal(port.live.vertices,
                                  np.asarray(jax_eng.live.vertices))
    np.testing.assert_array_equal(port.live.mask,
                                  np.asarray(jax_eng.live.mask))
    assert int(port.live.mask.sum()) > 500
    got, want = _port_outputs(port), _outputs(jax_eng, np.array)
    for k in ("mc_dropped", "corr_dropped", "count"):
        assert got[k] == want[k]
    assert port.mesh_vertices is None and jax_eng.mesh_vertices is None
    m = want["mask"]
    np.testing.assert_allclose(got["warped"][m], want["warped"][m], rtol=0,
                               atol=1e-4)
    verts, n = port.mesh()
    assert int(n) > 0 and torch.isfinite(verts[:int(n)]).all()
