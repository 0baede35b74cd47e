"""The benchmark's CPU tests: the harness, its generator and its readers at
sizes a CPU holds. Tests marked `cuda` need the card and skip here."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

TINY_CAMERA = {"rows": 120, "cols": 160, "fx": 131.25, "fy": 131.25}


def tiny_bench(tmp_path: Path, dims: int = 128) -> dict:
    """BENCHMARK.json with its configurations cut to a 160x120 camera and a
    dims^3 volume (the port's caps_for_volume(dims)), in tmp_path."""
    from dynfu_tpu_torch.engine.params import DynFuParams

    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        c = json.loads((BENCH.parent / conf["file"]).read_text())
        c["camera"] = dict(TINY_CAMERA)
        c["kinfu"]["volume_dims"] = [dims] * 3
        if "dynfu" in c:
            c["dynfu"].update(DynFuParams.caps_for_volume(dims))
        path = tmp_path / f"{conf['name']}.json"
        path.write_text(json.dumps(c))
        conf["file"] = str(path)
    return bench


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
