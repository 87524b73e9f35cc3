"""The port stands alone: no module of yololp_tpu_torch/, and not
chip_smoke.py, imports jax, flax or the JAX package, and every entry point
refuses to fall back to the CPU when no GPU is present."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yololp_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "yololp_tpu"}
# cv2 and msgpack are absent on the machine with the card: imported lazily only
LAZY = {"cv2", "msgpack"}


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def port_modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name.split(".")[0], node) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    assert (ROOT / "chip_smoke.py").is_file()
    for path in port_files():
        tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
        top_level = set(tree.body)
        for root, node in imported_roots(tree):
            assert root not in FORBIDDEN, f"{path.relative_to(ROOT)}:{node.lineno} imports {root}"
            if root in LAZY:
                assert node not in top_level, (
                    f"{path.relative_to(ROOT)}:{node.lineno} imports {root} at module level")


def test_every_port_module_imports_without_jax_cv2_or_msgpack():
    blocked = ", ".join(f"{m!r}: None" for m in sorted(FORBIDDEN | LAZY))
    code = (f"import importlib, sys\nsys.modules.update({{{blocked}}})\n"
            f"for m in {port_modules()!r}:\n    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.tools.infer import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Inferer(str(tmp_path), None, "yololpn", img_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--source", str(tmp_path), "--conf-file", "yololpn", "--not-save-img"])
    # the CPU is taken only when asked for, and then runs the plain NMS
    inf = Inferer(str(tmp_path), None, "yololpn", img_size=64, half=False, device="cpu")
    assert len(inf.detect_batch([np.zeros((64, 64, 3), np.uint8)])) == 1
