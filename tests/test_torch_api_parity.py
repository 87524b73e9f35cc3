"""Every public name of the JAX package has its counterpart in the port,
or stands on the list of names decided against, with its reason
(ROADMAP.md, "Decided not to port", repeats each).

Read by `ast`, importing neither package. A module of yololp_tpu/ maps to
the same path under yololp_tpu_torch/, except the Pallas modules, whose
counterparts are the CUDA kernels' wrappers (RENAMED). The JAX module's
public names are those it defines at top level (def, class, assignment)
without a leading underscore; its imports are other modules' names. The
port's module may also hold a name by import: a re-export counts
(ops/nms.py's greedy_nms_mask is ops/cuda_nms.py's).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "yololp_tpu", ROOT / "yololp_tpu_torch"

# JAX module -> (its counterpart in the port, {JAX name: port name})
RENAMED = {
    "ops/pallas_nms.py": ("ops/cuda_nms.py", {"pallas_greedy_nms_mask": "greedy_nms_mask"}),
    "ops/pallas_conv.py": ("ops/cuda_conv.py", {"chain_repblock_pallas": "chain_repblock_fused"}),
}

# (JAX module, name) -> why the port has no counterpart
DECIDED = {
    ("layers/blocks.py", "BatchNorm"):
        "a flax nn.BatchNorm subclass that only sets eps and momentum; the port's BN is "
        "layers/blocks.py:BatchNorm2d (made by batch_norm()), with flax's update of the "
        "running variance",
    ("layers/fuse.py", "fuse_variables_jit"):
        "jax.jit around fuse_variables, one compiled program in place of hundreds of eager "
        "dispatches on a remote TPU; the port fuses eagerly (fuse_state_dict, fuse_variables)",
    ("data/device_cache.py", "put_replicated"):
        "places host arrays through jax.make_array_from_callback on a sharding that may span "
        "hosts; the port's cache lives on one card a process, and "
        "parallel/mesh.py:replicated(mesh).put puts an array on every device of a mesh",
    ("export/export.py", "export_stablehlo"):
        "StableHLO is XLA's interchange format; the port's artifacts are the .pt2 and the "
        "AOTInductor package",
}


def defined_names(tree):
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def held_names(tree):
    out = defined_names(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def parse(path):
    return ast.parse(path.read_text(encoding="utf-8"), str(path))


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_every_jax_module_is_read():
    assert len(JAX_MODULES) > 50 and "parallel/mesh.py" in JAX_MODULES


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_names_have_a_counterpart(module):
    port_module, renamed = RENAMED.get(module, (module, {}))
    port_path = PORT_PKG / port_module
    assert port_path.is_file(), f"yololp_tpu/{module} has no counterpart {port_module}"
    held = held_names(parse(port_path))
    missing = sorted(n for n in defined_names(parse(JAX_PKG / module))
                     if renamed.get(n, n) not in held and (module, n) not in DECIDED)
    assert not missing, f"yololp_tpu_torch/{port_module} lacks {missing}"


def test_names_decided_against_are_absent_and_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text(encoding="utf-8")
    decided_section = roadmap[roadmap.index("Decided not to port"):]
    for (module, name), reason in DECIDED.items():
        assert name in defined_names(parse(JAX_PKG / module)), (module, name)
        assert name not in held_names(parse(PORT_PKG / module)), (
            f"{name} is ported now: drop it from DECIDED")
        assert f"`{name}`" in decided_section, f"ROADMAP does not record {name}"
        assert reason
