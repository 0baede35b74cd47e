"""PyTorch port vs JAX reference on the CPU: the dataset application.

The PNG codec of io/meshio against PIL (the JAX package's decoder) on the
vendored umbrella frames and on PNGs built here with each row filter; the
threaded loader, native and codec; the exporters' bytes; the renders; the
engines' render(); checkpoints written and read by either package; the
`dynfu-torch` app and CLI on a tiny synthetic sequence. Inputs come from
seeded numpy generators. The tests marked `cuda` repeat the resume and the
render on the card and skip without one.
"""

import dataclasses
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.engine.kinfu import KinFu as JaxKinFu
from dynfu_tpu.io import datasets as jdatasets
from dynfu_tpu.io import meshio as jmeshio
from dynfu_tpu.io import native_loader as jnative
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.utils import checkpoint as jckpt
from dynfu_tpu.utils import viz as jviz
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.engine.params import DynFuParams, KinFuParams
from dynfu_tpu_torch.io import app, cli, datasets, meshio, native_loader
from dynfu_tpu_torch.ops import imgproc as timg
from dynfu_tpu_torch.utils import benchmarks, checkpoint, convert, viz
from dynfu_tpu_torch.volume import tsdf as tv

from test_native_and_checkpoint import _tiny_engine
from test_torch_fusion import _jax_knn_through_pallas

REPO = Path(__file__).resolve().parents[1]
UMBRELLA = sorted((REPO / "data" / "umbrella" / "depth").glob("*.png"))

torch.set_num_threads(1)


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


# --- the PNG codec ---------------------------------------------------------


@pytest.mark.parametrize("i", range(16))
def test_umbrella_frame_decodes_like_pil(i):
    """The vendored frames (640x480, 16-bit grey, Sub and Up rows) decode to
    PIL's arrays exactly."""
    assert len(UMBRELLA) == 16
    got = meshio.load_depth_png(str(UMBRELLA[i]))
    want = jmeshio.load_depth_png(str(UMBRELLA[i]))
    assert got.dtype == want.dtype == np.int32 and got.shape == (480, 640)
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """The PNG scanlines of (h, stride) uint8 `rows`, row y filtered with
    ftypes[y] (PNG spec 9.2), written with whole-row numpy arithmetic."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, f in enumerate(ftypes):
        x = rows[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][f]
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(w, h, depth, ctype, scan: bytes, interlace=0) -> bytes:
    """A PNG whose data is split over two IDAT chunks."""
    z = zlib.compress(scan)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


KINDS = {"grey8": (0, 8, 1), "grey16": (0, 16, 1), "rgb8": (2, 8, 3),
         "rgb16": (2, 16, 3), "rgba8": (6, 8, 4)}


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_filters_decode_like_pil(tmp_path, kind, filt):
    """A 13x7 image of seeded bytes, every row with one filter (or row y
    with filter y % 5): the port's depth and colour loaders give PIL's
    arrays exactly."""
    ctype, depth, ch = KINDS[kind]
    w, h = 13, 7
    bpp = ch * depth // 8
    rows = np.random.default_rng(sum(map(ord, kind))).integers(
        0, 256, (h, w * bpp), dtype=np.uint8)
    ftypes = [y % 5 for y in range(h)] if filt == "mixed" else [filt] * h
    path = str(tmp_path / "img.png")
    with open(path, "wb") as f:
        f.write(_png(w, h, depth, ctype, _filtered(rows, bpp, ftypes)))
    np.testing.assert_array_equal(meshio.load_depth_png(path),
                                  jmeshio.load_depth_png(path))
    np.testing.assert_array_equal(meshio.load_color_png(path),
                                  jmeshio.load_color_png(path))


@pytest.mark.parametrize("ctype,depth,interlace", [
    (0, 16, 1),  # interlaced
    (3, 8, 0),  # palette
    (4, 8, 0),  # grey + alpha
    (0, 4, 0),  # 4-bit grey
])
def test_png_rejects_unsupported(tmp_path, ctype, depth, interlace):
    path = str(tmp_path / "img.png")
    with open(path, "wb") as f:
        f.write(_png(4, 2, depth, ctype, bytes(2 * 9), interlace))
    with pytest.raises(ValueError):
        meshio.load_depth_png(path)


def test_pgm_16bit_decodes_like_pil(tmp_path):
    """A binary 16-bit PGM with a comment line, against PIL."""
    img = np.random.default_rng(1).integers(0, 65536, (9, 11),
                                            dtype=np.uint16)
    path = str(tmp_path / "d.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n# depth\n11 9\n65535\n" + img.astype(">u2").tobytes())
    got = meshio.load_depth_png(path)
    np.testing.assert_array_equal(got, img.astype(np.int32))
    np.testing.assert_array_equal(got, jmeshio.load_depth_png(path))


@pytest.mark.parametrize("kind", ["depth16", "grey8", "rgb8", "rgba8"])
def test_png_writer_reads_back_through_pil(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "w.png")
    if kind == "depth16":
        d = rng.integers(0, 65536, (17, 23)).astype(np.int32)
        d[0, :3] = (0, 65535, 1)
        meshio.save_depth_png(path, d)
        np.testing.assert_array_equal(jmeshio.load_depth_png(path), d)
        np.testing.assert_array_equal(meshio.load_depth_png(path), d)
        return
    shape = {"grey8": (17, 23), "rgb8": (17, 23, 3), "rgba8": (17, 23, 4)}
    img = rng.integers(0, 256, shape[kind], dtype=np.uint8)
    meshio.save_image_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


# --- the loader ------------------------------------------------------------


@pytest.mark.parametrize("decoder", ["native", "codec"])
def test_depth_loader_equals_jax(monkeypatch, decoder):
    """DepthLoader over the first six umbrella frames: the native decoder
    (native/dynfu_loader.cpp, built at first use) and the codec give the
    JAX loader's arrays."""
    paths = [str(p) for p in UMBRELLA[:6]]
    if decoder == "codec":
        monkeypatch.setattr(native_loader, "_load", lambda: None)
    elif not native_loader.available():
        pytest.fail("the native loader did not build (g++ and libpng are "
                    "expected here)")
    want = jnative.DepthLoader(paths, queue_depth=2, threads=2)
    with native_loader.DepthLoader(paths, queue_depth=2, threads=2) as got:
        assert got.native == (decoder == "native")
        for i in range(len(paths)):
            np.testing.assert_array_equal(got[i], want[i])
    want.close()


def test_unloadable_library_falls_back_to_codec(monkeypatch, tmp_path):
    """A library that does not load (built on a machine with libpng, run
    on one without) leaves the loader on the codec."""
    bad = tmp_path / "libdynfu_loader.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_find_or_build_lib", lambda: bad)
    with native_loader.DepthLoader([str(UMBRELLA[0])]) as got:
        assert not got.native
        np.testing.assert_array_equal(
            got[0], jmeshio.load_depth_png(str(UMBRELLA[0])))


# --- exports and the synthetic sequence ------------------------------------


def _soup(seed=3):
    """A seeded triangle soup with shared vertices (each of 40 points used
    ~4x), as marching cubes emits."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    return pts[rng.integers(0, 40, 3 * 50)]


@pytest.mark.parametrize("fmt", ["pcd", "vtk", "ply", "ply_indexed"])
def test_exports_equal_jax_bytes(tmp_path, fmt):
    soup = _soup()
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    if fmt == "ply_indexed":
        verts, faces = jmeshio._soup_to_indexed(soup)
        tv, tf = meshio._soup_to_indexed(soup)
        np.testing.assert_array_equal(tv, verts)
        np.testing.assert_array_equal(tf, faces)
        meshio.save_ply_indexed(a, tv, tf)
        jmeshio.save_ply_indexed(b, verts, faces)
    else:
        getattr(meshio, f"save_{fmt}")(a, soup)
        getattr(jmeshio, f"save_{fmt}")(b, soup)
    assert Path(a).read_bytes() == Path(b).read_bytes()


def test_generate_synthetic_and_cli_synth_equal_jax(tmp_path):
    """datasets.generate_synthetic and `dynfu-torch synth` write the JAX
    generator's frames (decoded arrays equal; the PNG bytes differ only in
    compression)."""
    jdatasets.generate_synthetic(str(tmp_path / "j"), frames=3, h=24, w=32)
    datasets.generate_synthetic(str(tmp_path / "t"), frames=3, h=24, w=32)
    assert cli.main(["synth", str(tmp_path / "c"), "--frames", "3",
                     "--rows", "24", "--cols", "32"]) == 0
    jd, _ = jmeshio.list_dataset(str(tmp_path / "j"))
    for sub in ("t", "c"):
        td, _ = meshio.list_dataset(str(tmp_path / sub))
        assert [Path(p).name for p in td] == [Path(p).name for p in jd]
        for p, q in zip(td, jd):
            want = jmeshio.load_depth_png(q)
            assert (want > 0).any()
            np.testing.assert_array_equal(jmeshio.load_depth_png(p), want)


# --- renders ----------------------------------------------------------------

RINTR = (100.0, 100.0, 79.5, 59.5)


def _maps():
    """Seeded 120x160 depth with 10 % holes, and JAX's point and normal
    maps of it (NaN at the holes and their neighbours)."""
    rng = np.random.default_rng(4)
    d = rng.integers(500, 2500, (120, 160)).astype(np.int32)
    d[rng.random(d.shape) < 0.1] = 0
    p, n = jimg.compute_points_normals(jnp.asarray(d), JIntr(*RINTR))
    return d, np.asarray(p), np.asarray(n)


@pytest.mark.parametrize("fn", ["points", "depth", "tangent", "merge"])
def test_renders_equal_jax(fn):
    """uint8 equal to JAX's everywhere (no pixel differs by a level)."""
    d, p, n = _maps()
    light = (0.1, 0.2, -0.3)
    if fn == "points":
        want = jimg.render_image_points(p, n, light)
        got = timg.render_image_points(torch.as_tensor(p),
                                       torch.as_tensor(n), light)
    elif fn == "depth":
        want = jimg.render_image_depth(d, n, JIntr(*RINTR), light)
        got = timg.render_image_depth(torch.as_tensor(d), torch.as_tensor(n),
                                      Intr(*RINTR), light)
    elif fn == "tangent":
        want = jimg.render_tangent_colors(n)
        got = timg.render_tangent_colors(torch.as_tensor(n))
    else:
        pf, nf = p.reshape(-1, 3), n.reshape(-1, 3)
        want = jimg.merge_point_normal(pf, nf)
        got = timg.merge_point_normal(torch.as_tensor(pf),
                                      torch.as_tensor(nf))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_render_cloud_equals_jax():
    _, p, _ = _maps()
    pts = p.reshape(-1, 3)
    want = jviz.render_cloud(pts, JIntr(*RINTR), shape=(120, 160))
    got = viz.render_cloud(torch.as_tensor(pts), Intr(*RINTR),
                           shape=(120, 160))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", [0, 1, 2, 3])
def test_kinfu_render_from_jax_state(flag):
    """KinFu.render(flag) of the same reference pyramid (JAX's, loaded
    through utils/convert.py) gives JAX's image exactly."""
    from test_pipeline import scene_depth, small_kinfu_params

    jp = small_kinfu_params()
    jeng = JaxKinFu(jp)
    pts, nrm = jimg.compute_points_normals(jnp.asarray(scene_depth()),
                                           jp.intr)
    jeng.prev_pyr = [(pts, nrm)]
    port = convert.load_kinfu_state(
        KinFu(convert.params(jp), device="cpu"),
        vol=tuple(np.array(a) for a in jeng.vol), poses=jeng.poses,
        prev_pyr=[(np.array(pts), np.array(nrm))], frame_counter=1)
    want = np.asarray(jeng.render(flag))
    got = port.render(flag).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _port_tiny(device="cpu", mode="parity"):
    """The port of the JAX checkpoint tests' tiny engine (32^3, 48x64)."""
    jdf, depth = _tiny_engine()
    return DynFusion(convert.params(jdf.dynfu_params), device=device,
                     mode=mode), depth


def _tiny_frames(n=4):
    from dynfu_tpu.io.datasets import sphere_depth

    return [sphere_depth((0.01 * i, 0.0, 0.6), 0.2, 48, 64, 70.0, 70.0,
                         31.5, 23.5) for i in range(n)]


def test_dynfusion_render_against_raycast_march():
    """DynFusion.render(0) against JAX's Phong of JAX's raycast_march of
    the same volume and pose: the raycasts as the port's raycast tests hold
    them (hit masks agree on >= 99.5 % of pixels, points within 1e-4 m);
    the images equal on >= 99 % of pixels, and where both rays hit, within
    one level on all but 0.5 % of pixels (the normals differ by float32
    roundoff, up to 2e-3)."""
    eng, _ = _port_tiny()
    for d in _tiny_frames(2):
        eng(d)
    img = eng.render(0).numpy()
    p = eng.params
    cfg = eng.tsdf_config
    jcfg = jtv.TsdfConfig(cfg.dims, cfg.size, cfg.trunc_dist, cfg.max_weight,
                          cfg.raycast_step_factor, cfg.gradient_delta_factor)
    vol = jtv.TsdfVolume(*(jnp.asarray(t.numpy()) for t in eng.vol))
    pose = tuple(jnp.asarray(a) for a in eng.poses[-1])
    jintr = JIntr(p.intr.fx, p.intr.fy, p.intr.cx, p.intr.cy)
    jp, jn = jtv.raycast_march(vol, pose, jintr, (p.rows, p.cols), jcfg)
    want = np.asarray(jimg.render_image_points(jp, jn, p.light_pose))
    tp = tv.raycast(eng.vol, eng.poses[-1], p.intr, (p.rows, p.cols),
                    cfg)[0].numpy()
    jp = np.asarray(jp)
    hj, ht = ~np.isnan(jp[..., 0]), ~np.isnan(tp[..., 0])
    assert hj.sum() > 200 and (hj == ht).mean() >= 0.995
    assert np.abs(jp[hj & ht] - tp[hj & ht]).max() <= 1e-4
    diff = np.abs(img.astype(int) - want).max(-1)
    assert (diff == 0).mean() >= 0.99
    assert (diff[hj & ht] > 1).mean() <= 0.005


# --- checkpoints -------------------------------------------------------------


def _state(e):
    """Every tensor a resumed frame reads or the app exports."""
    wv, wm = e.warped_cloud()
    out = {"tsdf": e.vol.tsdf, "weight": e.vol.weight, "wv": wv, "wm": wm,
           "mesh": e.mesh()[0]}
    out.update({f"wf_{k}": v for k, v in e.warpfield._asdict().items()})
    return {k: v.cpu() for k, v in out.items()}


def _resume_pair(tmp_path, device, mode):
    """(uninterrupted, resumed) tiny engines after four frames; the resumed
    one loads the checkpoint the first one wrote after frame 1 (frame 2
    for fixed mode, whose ICP reference is rebuilt on load)."""
    frames = _tiny_frames(4)
    at = 3 if mode == "fixed" else 2
    a, _ = _port_tiny(device, mode)
    path = str(tmp_path / "ckpt.npz")
    for i, d in enumerate(frames):
        a(d)
        if i == at - 1:
            checkpoint.save_checkpoint(a, path)
    b, _ = _port_tiny(device, mode)
    checkpoint.load_checkpoint(b, path)
    assert b.frame_counter == at
    for d in frames[at:]:
        b(d)
    return a, b


@pytest.mark.parametrize("mode", ["parity", "fixed"])
def test_resume_is_bitwise_on_cpu(tmp_path, mode):
    a, b = _resume_pair(tmp_path, "cpu", mode)
    sa, sb = _state(a), _state(b)
    assert int(sa["wf_count"]) > 3 and bool(sa["wm"].any())
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert len(a.poses) == len(b.poses)
    for (ra, ta), (rb, tb) in zip(a.poses, b.poses):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ta, tb)


def test_jax_checkpoint_continues_in_port(tmp_path):
    """A checkpoint JAX wrote after frame 1 loads into the port, and the
    port's frame 2 agrees with JAX's frame 2: the same node count and
    masks, the warped cloud within 1e-4 m (the stepwise tests' bound).
    JAX's k-NN runs its TPU kernel in interpret mode, as the stepwise
    tests run it."""
    frames = _tiny_frames(3)
    path = str(tmp_path / "jax.npz")
    df, _ = _tiny_engine()
    with _jax_knn_through_pallas():
        for i, d in enumerate(frames):
            df(d)
            wf = df.warpfield  # pin dg_w's type: one compile of the frame
            df.warpfield = wf._replace(w=jnp.asarray(np.array(wf.w)))
            if i == 1:
                jckpt.save_checkpoint(df, path)
    port, _ = _port_tiny()
    checkpoint.load_checkpoint(port, path)
    assert port.frame_counter == 2
    port(frames[2])
    jv, jm = (np.asarray(a) for a in df.warped_cloud())
    tv_, tm = (a.numpy() for a in port.warped_cloud())
    assert int(port.warpfield.count) == int(df.warpfield.count) > 3
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv_[jm], jv[jm], rtol=0, atol=1e-4)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's checkpoint: JAX's load_checkpoint restores equal arrays,
    and the same keys, dtypes and meta as a JAX checkpoint."""
    port, _ = _port_tiny()
    for d in _tiny_frames(2):
        port(d)
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port, path)
    df, _ = _tiny_engine()
    jckpt.load_checkpoint(df, path)
    assert df.frame_counter == port.frame_counter == 2
    pairs = [(df.vol.tsdf, port.vol.tsdf), (df.vol.weight, port.vol.weight),
             (df.warpfield.pos, port.warpfield.pos),
             (df.warpfield.dqs, port.warpfield.dqs),
             (df.warpfield.count, port.warpfield.count),
             (df.canonical.vertices, port.canonical.vertices),
             (df.canonical_warped.vertices, port.canonical_warped.vertices),
             (df.soup_inverse, port.soup_inverse)]
    for j, t in pairs:
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    for (jr, jt), (r, t) in zip(df.poses, port.poses):
        np.testing.assert_array_equal(np.asarray(jr), r)
        np.testing.assert_array_equal(np.asarray(jt), t)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(df, jpath)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert json.loads(bytes(a["meta"])) == json.loads(bytes(b["meta"]))


# --- the app and the CLI -------------------------------------------------------


def _app_params(h=48, w=64):
    return DynFuParams(
        kinfu=KinFuParams(rows=h, cols=w,
                          intr=Intr(70.0, 70.0, w / 2 - 0.5, h / 2 - 0.5),
                          volume_dims=(64,) * 3),
        **DynFuParams.caps_for_volume(64))


def test_run_dataset_resume_equals_uninterrupted(tmp_path):
    """run_dataset on the CPU over a 4-frame synthetic sequence: with
    export_viz every artifact of every frame; a run of 2 frames that
    checkpoints, resumed over the rest, writes frames 2-3's .pcd, .vtk and
    .ply byte-equal to the uninterrupted run's."""
    seq = str(tmp_path / "seq")
    datasets.generate_synthetic(seq, frames=4, h=48, w=64, fx=70.0, fy=70.0)
    a, b, c = (str(tmp_path / n) for n in "abc")
    kw = dict(params=_app_params(), device="cpu")
    assert app.run_dataset(seq, out_dir=a, export_viz=True, **kw) == 0
    for i in range(4):
        for name in (f"pcl_canonical_to_live{i}.pcd", f"{i}_tsdf_mesh.vtk",
                     f"{i}_tsdf_mesh.ply", f"render{i}.png"):
            assert (Path(a) / name).stat().st_size > 200, name
    img = meshio.read_image(str(Path(a) / "render3.png"))
    assert img.shape == (48, 64, 3)
    assert app.run_dataset(seq, out_dir=b, max_frames=2, checkpoint_every=2,
                           **kw) == 0
    assert app.run_dataset(seq, out_dir=c, resume=str(Path(b) /
                                                      "checkpoint.npz"),
                           **kw) == 0
    assert not (Path(c) / "pcl_canonical_to_live1.pcd").exists()
    for i in (2, 3):
        for name in (f"pcl_canonical_to_live{i}.pcd", f"{i}_tsdf_mesh.vtk",
                     f"{i}_tsdf_mesh.ply"):
            assert (Path(c) / name).read_bytes() == \
                (Path(a) / name).read_bytes(), name


def test_cli_rigid_writes_trajectory_and_mesh(tmp_path):
    seq = str(tmp_path / "seq")
    datasets.generate_synthetic(seq, frames=3, h=48, w=64, fx=70.0, fy=70.0)
    out = tmp_path / "r"
    assert cli.main(["--cpu", "run", "--rigid", seq, "--volume-dims", "64",
                     "--export-viz", "--out", str(out)]) == 0
    assert np.loadtxt(out / "trajectory.txt").shape == (3, 12)
    assert (out / "rigid_mesh.ply").read_text().startswith("ply\n")
    assert (out / "rigid_render0.png").exists()


def test_cli_without_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    """Without a card and without --cpu, run and bench exit 1 with a
    message, and write nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = str(tmp_path / "seq")
    datasets.generate_synthetic(seq, frames=1, h=24, w=32)
    assert cli.main(["run", seq, "--out", str(tmp_path / "o")]) == 1
    assert cli.main(["bench"]) == 1
    assert "--cpu" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_run_dataset_devices_raises(tmp_path):
    """devices > 1 runs the sharded parity or fusion engine
    (tests/test_torch_dist.py); what it does not shard raises before any
    rank starts: fixed mode, fusion mode with camera tracking, and the
    rigid pipeline."""
    with pytest.raises(NotImplementedError, match="parity"):
        app.run_dataset(str(tmp_path), devices=2, mode="fixed",
                        device="cpu")
    tracking = dataclasses.replace(DynFuParams.default_params(),
                                   fusion_camera_tracking=True)
    with pytest.raises(NotImplementedError, match="camera"):
        app.run_dataset(str(tmp_path), devices=2, mode="fusion",
                        params=tracking, device="cpu")
    with pytest.raises(ValueError, match="rigid"):
        app.run_dataset(str(tmp_path), devices=2, rigid=True, device="cpu")


def test_no_port_module_imports_pil():
    code = ("import importlib, pkgutil, sys\n"
            "import dynfu_tpu_torch\n"
            "for m in pkgutil.walk_packages(dynfu_tpu_torch.__path__,"
            " 'dynfu_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] == 'PIL')\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


STAGES = ["preprocess_dists", "clear_integrate", "marching_cubes",
          "warp_canonical", "correspondence_1nn", "gn_solve",
          "node_insertion", "fused_full_frame"]
FUSION_STAGES = ["preprocess", "points_normals", "warp_canonical",
                 "integrate_warped_band", "marching_cubes_corner",
                 "extract_normals", "warp_new_mesh", "frame_solve_disabled",
                 "fused_full_frame"]


@pytest.mark.parametrize("which", ["parity", "fusion"])
def test_stage_benchmarks_keys(monkeypatch, which):
    """The source's keys and stage names (those its code gives without
    unique edge vertices), on the CPU at 64^3 and 120x160. The capacities
    are cut below the 64^3 preset so that the CPU's plain versions finish
    in about a second."""
    caps = DynFuParams.caps_for_volume
    monkeypatch.setattr(DynFuParams, "caps_for_volume", staticmethod(
        lambda d, fusion=False: dict(
            caps(d, fusion), fusion_max_active=1 << 12, max_vertices=1 << 11,
            max_mc_voxels=1 << 10, max_nodes=64, max_new_nodes=32)))
    kw = dict(iters=1, rows=120, cols=160, warmup_frames=2, device="cpu")
    if which == "parity":
        res = benchmarks.run_stage_benchmark(64, **kw)
        keys, names = ["n_mesh_verts"], STAGES
    else:
        res = benchmarks.run_fusion_stage_benchmark(64, **kw)
        keys = ["n_mesh_verts", "n_extract_dropped", "n_band"]
        names = FUSION_STAGES
    assert sorted(res) == sorted(["metric", "value", "unit", "vs_baseline",
                                  "stages_ms", "device"] + keys)
    assert list(res["stages_ms"]) == names
    assert all(v > 0 for v in res["stages_ms"].values())
    assert res["value"] == res["stages_ms"]["fused_full_frame"]
    assert res["n_mesh_verts"] > 0 and res["device"] == "cpu"


# --- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parity", "fixed"])
def test_resume_is_bitwise_on_card(tmp_path, dev, mode):
    a, b = _resume_pair(tmp_path, dev, mode)
    sa, sb = _state(a), _state(b)
    assert int(sa["wf_count"]) > 3
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.cuda
def test_render_card_against_cpu(tmp_path, dev):
    """DynFusion.render(0..3) of one checkpointed state, on the card and on
    the CPU: equal on >= 99 % of pixels (the raycast's float32 roundoff
    differs between the two; a flipped hit at a silhouette changes a
    pixel wholly)."""
    cpu, _ = _port_tiny()
    for d in _tiny_frames(2):
        cpu(d)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(cpu, path)
    card, _ = _port_tiny(dev)
    checkpoint.load_checkpoint(card, path)
    for flag in range(4):
        got = card.render(flag).cpu().numpy()
        want = cpu.render(flag).numpy()
        assert got.shape == want.shape
        assert (got == want).all(-1).mean() >= 0.99, flag


def test_check_platform_never_falls_back(monkeypatch):
    """utils/device.check_platform: the CPU only when asked for; a CUDA
    device without a card raises."""
    from dynfu_tpu_torch.utils import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.check_platform("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--cpu"):
        device.check_platform("cuda")
    assert device.devices() == [] or torch.cuda.device_count() > 0
