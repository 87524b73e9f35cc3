"""Every public name of the JAX package has its counterpart in the port,
or stands on the list of names decided against, with its reason
(docs/port_decided.md, "Decided not to port", repeats each).

Read by `ast`, importing neither package. A module of yololp_tpu/ maps to
the same path under yololp_tpu_torch/, except the Pallas modules, whose
counterparts are the CUDA kernels' wrappers (RENAMED). The JAX module's
public names are those it defines at top level (def, class, assignment)
without a leading underscore; its imports are other modules' names. The
port's module may also hold a name by import: a re-export counts
(ops/nms.py's greedy_nms_mask is ops/cuda_nms.py's).

Below the names, every parameter of every public JAX function and method
(a public class's methods, `__init__` and `__call__` included) has a
parameter of the same name in its port counterpart, or stands in
PARAM_RENAMED with the port's name, or in PARAM_DECIDED with the reason the
port has none (docs/port_decided.md repeats each). A flax module's `__call__` maps to
the torch module's `forward`; a method the port class inherits is looked up
in its bases. And every `--flag` of a JAX CLI in tools/, with each of its
`choices`, is in the port's parser of the same name.
"""

import ast
from fnmatch import fnmatch
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "yololp_tpu", ROOT / "yololp_tpu_torch"
# the port's record of what it leaves out, edited only with the port's code
DECIDED_DOC = ROOT / "docs" / "port_decided.md"

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
    """Each decided name is still absent from the port and recorded, in
    backticks, in docs/port_decided.md (once ROADMAP.md's section)."""
    record = DECIDED_DOC.read_text(encoding="utf-8")
    decided_section = record[record.index("Decided not to port"):]
    for (module, name), reason in DECIDED.items():
        assert name in defined_names(parse(JAX_PKG / module)), (module, name)
        assert name not in held_names(parse(PORT_PKG / module)), (
            f"{name} is ported now: drop it from DECIDED")
        assert f"`{name}`" in decided_section, f"{DECIDED_DOC.name} does not record {name}"
        assert reason


# ---- parameters ------------------------------------------------------------

# Reasons shared by several entries of PARAM_DECIDED
CARRIES = ("a torch module carries its weights (and BN statistics): the port takes the "
           "model where the JAX function takes a flax variables tree beside it")
APPLY_KW = ("keywords passed on to flax's Module.apply (mutable, rngs); the port calls the "
            "torch model on x, its train mode set by model.train() / model.eval()")
BN_EPS = ("the port folds each BN with the eps its blocks are built with, "
          "layers/blocks.py:BN_EPS, the JAX default")
COUNTS = "the port exports the model it is given, which carries its class counts"
PALLAS = ("Pallas' row tiling and interpret mode: the CUDA kernel picks its own tiles, and "
          "on a CPU tensor the op runs the kernel's plain version")

# (JAX module, function or Class.method, parameter) -> the port's parameter.
# The module and function may be fnmatch patterns.
PARAM_RENAMED = {
    ("core/train_step.py", "init_train_state", "variables"): "model",
    ("data/device_cache.py", "make_cached_*", "batch_sharding"): "shard",
    ("export/export.py", "build_export_fn", "config"): "model",
    ("layers/fuse.py", "fold_conv_bn", "kernel"): "weight",
    ("layers/fuse.py", "fold_conv_bn", "bn_params"): "bn",
    ("layers/fuse.py", "fold_conv_bn", "bn_stats"): "bn",
    ("layers/fuse.py", "f*", "params"): "node",
    ("layers/fuse.py", "f*", "stats"): "node",
    ("quant/int8_infer.py", "quantize_kernels_int8", "params"): "state",
    ("quant/int8_infer.py", "make_int8_infer_fn", "variables"): "state",
    ("solver/build.py", "param_group_label", "path"): "key",
    ("solver/build.py", "ema_update", "ema_tree"): "ema",
    ("solver/build.py", "ema_update", "new_tree"): "new",
    ("solver/repopt.py", "*", "params"): "state_dict",
    ("solver/repopt.py", "reinitialize", "rng_key"): "generator",
}

# (JAX module, function or Class.method, parameter) -> why the port has no
# counterpart; patterns as above, and "*" as the parameter stands for all.
PARAM_DECIDED = {
    ("*", "*.__call__", "train"):
        "flax passes train to every call; a torch module holds it as module.training, "
        "set by model.train() / model.eval()",
    ("data/device_cache.py", "DeviceCachedData.__init__", "sharding"):
        "the port's device cache lives on one card a process (its device argument); the "
        "JAX cache is placed on a sharding that may span hosts",
    ("export/export.py", "build_export_fn", "half"):
        "the port exports the model it is given, which carries its dtype (bf16 or fp32)",
    ("export/export.py", "build_export_fn", "npro"): COUNTS,
    ("export/export.py", "build_export_fn", "nalp"): COUNTS,
    ("export/export.py", "build_export_fn", "nads"): COUNTS,
    ("export/export.py", "export_saved_model", "*"):
        "saved_model needs TensorFlow; the port's export_saved_model takes any arguments "
        "and raises",
    ("layers/fuse.py", "*", "eps"): BN_EPS,
    ("models/yolo.py", "build_model", "img_size"):
        "flax initializes its variables by tracing a dummy batch of this size, dtype and "
        "batch size; a torch module needs no example input, and model.to(dtype) casts it",
    ("models/yolo.py", "build_model", "dtype"): "as for img_size",
    ("models/yolo.py", "build_model", "batch_size"): "as for img_size",
    ("ops/pallas_conv.py", "conv3x3_int8_fused", "row_tile"): PALLAS,
    ("ops/pallas_*.py", "*", "interpret"): PALLAS,
    ("parallel/infer.py", "make_sharded_infer_fn", "variables"): CARRIES,
    ("quant/int8_infer.py", "int8_apply", "variables"): CARRIES,
    ("quant/quantize.py", "*", "variables"): CARRIES,
    ("quant/quantize.py", "quantize_weights", "params"): CARRIES,
    ("quant/*.py", "*", "apply_kwargs"): APPLY_KW,
}


def params_of(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
    return [n for n in names if n not in ("self", "cls")]


def functions(tree):
    """{name: def} of the module's public functions, and {class: (def,
    [base names])} of its classes."""
    funcs = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    classes = {n.name: (n, [b.id for b in n.bases if isinstance(b, ast.Name)])
               for n in tree.body if isinstance(n, ast.ClassDef)}
    return funcs, classes


def public_callables(tree):
    """[(qualified name, def)]: public functions, and the public classes'
    public methods with __init__ and __call__; properties hold no
    parameters and are left out."""
    funcs, classes = functions(tree)
    out = [(n, f) for n, f in funcs.items() if not n.startswith("_")]
    for cname, (cls, _) in classes.items():
        if cname.startswith("_"):
            continue
        for m in cls.body:
            if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and (not m.name.startswith("_") or m.name in ("__init__", "__call__"))
                    and not any(isinstance(d, ast.Name) and d.id == "property"
                                for d in m.decorator_list)):
                out.append((f"{cname}.{m.name}", m))
    return out


def port_def(module, qualname, depth=0):
    """The port's def of `qualname` in `module`, following re-exports
    (`from yololp_tpu_torch.x import name`) and, for a method, the class's
    bases in the same module; a flax `__call__` is the torch `forward`."""
    path = PORT_PKG / module
    if depth > 4 or not path.is_file():
        return None
    tree = parse(path)
    funcs, classes = functions(tree)
    head, _, method = qualname.partition(".")
    if not method and head in funcs:
        return funcs[head]
    if method and head in classes:
        todo, seen = [head], set()
        while todo:
            c = todo.pop(0)
            if c in seen or c not in classes:
                continue
            seen.add(c)
            for name in (method, "forward") if method == "__call__" else (method,):
                for m in classes[c][0].body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and m.name == name:
                        return m
            todo += classes[c][1]
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("yololp_tpu_torch."):
            for a in node.names:
                if (a.asname or a.name) == head:
                    sub = node.module[len("yololp_tpu_torch."):].replace(".", "/") + ".py"
                    found = port_def(sub, ".".join(filter(None, (a.name, method))), depth + 1)
                    if found is not None:
                        return found
    return None


def lookup(table, module, qualname, param):
    for (m, f, p), value in table.items():
        if fnmatch(module, m) and fnmatch(qualname, f) and p in ("*", param):
            return value
    return None


def dropped_params(module):
    """[(qualified name, JAX parameter, the port's parameters)] of the JAX
    module's parameters with no same-named counterpart; a JAX callable with
    no port counterpart at all is reported with parameter None."""
    port_module, renamed = RENAMED.get(module, (module, {}))
    out = []
    for qualname, fn in public_callables(parse(JAX_PKG / module)):
        head, _, method = qualname.partition(".")
        if (module, head) in DECIDED:
            continue
        port = port_def(port_module, ".".join(filter(None, (renamed.get(head, head), method))))
        if port is None:
            out.append((qualname, None, None))
            continue
        have = params_of(port)
        out += [(qualname, p, have) for p in params_of(fn) if p not in have]
    return out


DROPPED = {m: dropped_params(m) for m in JAX_MODULES}


def test_parameter_tables_read_the_package():
    n_params = sum(len(params_of(f)) for m in JAX_MODULES
                   for _, f in public_callables(parse(JAX_PKG / m)))
    assert n_params > 500
    assert port_def("layers/blocks.py", "SimConvWrapper.__call__") is not None  # inherited forward
    assert port_def("ops/nms.py", "greedy_nms_mask") is not None  # re-exported


@pytest.mark.parametrize("module", JAX_MODULES)
def test_parameters_have_a_counterpart(module):
    unexplained = []
    for qualname, param, have in DROPPED[module]:
        if param is None:
            unexplained.append(f"{qualname}: no counterpart in the port")
            continue
        new = lookup(PARAM_RENAMED, module, qualname, param)
        if new is not None:
            assert new in have, f"{qualname}: PARAM_RENAMED says {param} -> {new}, port has {have}"
        elif lookup(PARAM_DECIDED, module, qualname, param) is None:
            unexplained.append(f"{qualname}({param})")
    assert not unexplained, (f"yololp_tpu/{module}: parameters the port drops without a "
                             f"PARAM_RENAMED or PARAM_DECIDED entry: {unexplained}")


def test_parameter_tables_hold_no_stale_entry_and_the_roadmap_gives_each_reason():
    """Every entry still matches a dropped parameter, and the "Decided not to
    port" record (docs/port_decided.md, once ROADMAP.md's section) names
    each decided parameter and its function."""
    dropped = [(m, q, p) for m, rows in DROPPED.items() for q, p, _ in rows if p is not None]
    record = DECIDED_DOC.read_text(encoding="utf-8")
    decided_section = record[record.index("Decided not to port"):]
    for table in (PARAM_RENAMED, PARAM_DECIDED):
        for key, value in table.items():
            assert value, key
            assert any(lookup({key: 1}, m, q, p) for m, q, p in dropped), f"stale entry {key}"
    for (module, func, param) in PARAM_DECIDED:
        # a function by its name; a method by its qualified name, its class's or its own
        names = {n for m, q, p in dropped if lookup({(module, func, param): 1}, m, q, p)
                 for n in (q, *q.split("."))}
        if param != "*":
            assert f"`{param}`" in decided_section, f"{DECIDED_DOC.name} does not record {param}"
        assert any(f"`{n}`" in decided_section for n in names), (
            f"{DECIDED_DOC.name} names none of {sorted(names)} for {param}")


# ---- command lines ---------------------------------------------------------

# a JAX choice's value in the port, by flag
CHOICE_RENAMED = {"--device": {"tpu": "cuda"}}
# (JAX CLI, flag, choice) -> why the port has no such choice
CHOICE_DECIDED = {
    ("export.py", "--format", "stablehlo"):
        "StableHLO is XLA's interchange format (export_stablehlo above)",
}


def cli_flags(path):
    """{--flag: its choices or None} of every add_argument call in the file."""
    out = {}
    for node in ast.walk(parse(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            choices = next((ast.literal_eval(k.value) for k in node.keywords
                            if k.arg == "choices"), None)
            for a in node.args:
                if isinstance(a, ast.Constant) and str(a.value).startswith("--"):
                    out[a.value] = choices
    return out


JAX_CLIS = sorted(p.name for p in (ROOT / "tools").glob("*.py")
                  if (PORT_PKG / "tools" / p.name).is_file())


def test_every_ported_cli_is_read():
    assert len(JAX_CLIS) > 20 and {"infer.py", "eval.py", "train.py"} <= set(JAX_CLIS)


@pytest.mark.parametrize("cli", JAX_CLIS)
def test_cli_flags_and_choices_have_a_counterpart(cli):
    want, have = cli_flags(ROOT / "tools" / cli), cli_flags(PORT_PKG / "tools" / cli)
    assert want, cli
    missing = [f for f in want if f not in have]
    assert not missing, f"yololp_tpu_torch/tools/{cli} lacks {missing}"
    lacking = []
    for flag, choices in want.items():
        for c in choices or ():
            c = CHOICE_RENAMED.get(flag, {}).get(c, c)
            if have[flag] is not None and c not in have[flag] and (cli, flag, c) not in CHOICE_DECIDED:
                lacking.append(f"{flag} {c}")
    assert not lacking, f"yololp_tpu_torch/tools/{cli} refuses {lacking}"
