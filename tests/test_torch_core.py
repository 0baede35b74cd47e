"""PyTorch port vs JAX reference: dual quaternions, depth preprocessing,
and the port's import boundary (no jax).

Inputs are seeded numpy arrays handed to both packages; comparisons run on
the CPU, where the port's kernel wrappers use their plain versions."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import dualquat as jdq
from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu_torch.core import dualquat as tdq
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.ops import imgproc as timg

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# the reference suite's own tolerance (test/quaternion_test.cpp)
DQ_TOL = 1e-4


def _rand_dq(rng, n):
    # rotations below ~110 deg: tan(theta / 2) in dq_rodrigues stays far
    # from its pole, where f32 acos error would be amplified without bound
    rot = np.concatenate([np.ones((n, 1)), rng.normal(0, 0.5, (n, 3))], 1)
    rot = (rot / np.linalg.norm(rot, axis=1, keepdims=True)).astype(np.float32)
    t = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return np.array(jdq.dq_from_quat_translation(rot, t))


def _dq_cases(rng):
    n = 64
    a, b = _rand_dq(rng, n), _rand_dq(rng, n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    q4 = rng.normal(size=(n, 4)).astype(np.float32)
    t3 = rng.normal(size=(n, 3)).astype(np.float32)
    r3 = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    ang = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    return {
        "quat_mul": (q4, q4[::-1].copy()),
        "quat_normalize_cayley": (q4,),
        "dq_mul": (a, b),
        "dq_conj": (a,),
        "dq_scale": (a, s),
        "dq_normalize": (a * 1.5,),
        "dq_normalize_joint": (a * 1.5,),
        "dq_transform_point": (a, v),
        "dq_transform_normal": (a, v),
        "dq_rotate_vector": (a, v),
        "dq_translation": (a,),
        "dq_from_quat_translation": (q4, t3),
        "dq_from_translation": (t3,),
        "dq_from_rodrigues": (r3, t3),
        "dq_from_euler": (ang[0], ang[1], ang[2], 0.1, -0.2, 0.3),
        "dq_euler_angles": (a,),
        "dq_rodrigues": (a,),
    }


@pytest.mark.parametrize("name", sorted(_dq_cases(np.random.default_rng(0))))
def test_dualquat_matches_jax(name):
    args = _dq_cases(np.random.default_rng(0))[name]
    want = np.asarray(getattr(jdq, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(tdq, name)(
        *[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args]).numpy()
    np.testing.assert_allclose(got, want, atol=DQ_TOL, rtol=0)


def _depth(rng, H=48, W=64):
    d = rng.integers(400, 3000, (H, W)).astype(np.int32)
    d[rng.random((H, W)) < 0.1] = 0  # holes
    return d


def test_compute_dists_exact_f16():
    """Exact, including the float16 narrowing (the reference packs half)."""
    rng = np.random.default_rng(1)
    d = _depth(rng)
    intr = (140.0, 141.0, 31.5, 23.5)
    want = np.asarray(jimg.compute_dists(jnp.asarray(d), JIntr(*intr)))
    got = timg.compute_dists(torch.as_tensor(d), TIntr(*intr)).numpy()
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize,sig_s,sig_d,max_off", [
    (7, 4.5, 0.04, 0),  # the engine's parameters: exact
    (5, 2.0, 0.1, 2),
])
def test_bilateral_filter(ksize, sig_s, sig_d, max_off):
    """The rounded weighted mean, with the exclusive window bound. XLA's
    and PyTorch's float32 exp differ by one ulp on ~10% of arguments, so a
    mean within roundoff of a .5 boundary can round the other way: at most
    `max_off` pixels may differ, by 1 mm (the engine's parameters: none)."""
    rng = np.random.default_rng(2)
    d = _depth(rng)
    want = np.asarray(jimg.bilateral_filter(jnp.asarray(d), ksize, sig_s,
                                            sig_d))
    got = timg.bilateral_filter(torch.as_tensor(d), ksize, sig_s,
                                sig_d).numpy()
    off = got != want
    assert np.count_nonzero(off) <= max_off
    assert np.abs(got.astype(np.int64) - want).max() <= (1 if max_off else 0)


def test_truncate_depth_exact():
    d = _depth(np.random.default_rng(3))
    want = np.asarray(jimg.truncate_depth(jnp.asarray(d), 1.5))
    got = timg.truncate_depth(torch.as_tensor(d), 1.5).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_never_imports_jax():
    """`import dynfu_tpu_torch` and every submodule leave jax (and the JAX
    package) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dynfu_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynfu_tpu_torch.__path__,"
        " 'dynfu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith(('jax.', 'jaxlib', 'dynfu_tpu.')) or n == 'dynfu_tpu')\n"
        "n = sum(1 for n in sys.modules if n.startswith('dynfu_tpu_torch.'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_wrappers_reject_other_devices():
    """A wrapper runs its plain version only for CPU tensors; a tensor on
    any other non-CUDA device raises instead of falling back."""
    from dynfu_tpu_torch.mesh import mc_cuda

    meta = torch.empty((4, 5, 9), device="meta")
    with pytest.raises(ValueError):
        mc_cuda.pack_triangles(meta, meta[:, 0, 0].int(), meta[:, 0, 0].int(),
                               8)
