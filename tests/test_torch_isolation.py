"""The port stands alone: no jax and nothing of ``repro`` in ``src/repro_torch``
or ``chip_smoke.py``, and its entry points never fall back to the CPU.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve, train
from repro_torch.models import from_jax_params, init_decode_state, init_params
from repro_torch.runtime import BatchedServer, ServerConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.configs, repro_torch.kernels, "
            "repro_torch.models, repro_torch.runtime, repro_torch.launch.serve, "
            "repro_torch.core, repro_torch.optics, repro_torch.configs.optree_paper, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.runtime.trainer, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")


def test_entry_points_need_cuda_unless_cpu_is_asked_for(no_card):
    cfg = reduced(get_config("granite-3-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({}, cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(cfg, params, ServerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-3-2b", "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-3-2b", "--reduced", "--steps", "1"])


def test_chip_smoke_refuses_without_a_card_or_a_checkout(no_card, tmp_path):
    """It exits non-zero and prints no result line: here (no CUDA) and in
    a directory that holds chip_smoke.py and nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
