"""The kernel build's cache key (ops/_build.py), the binding of every entry
point the port calls, and the layout helpers the kernels' tensor maps rely
on (ops/cuda_matmul.py:rows16), on the CPU.

No nvcc is needed: a library's name is a hash of its source, the headers
beside it and the flags, and is computed without building.
"""

import ctypes
import re
import types

import pytest
import torch

import yololp_tpu_torch.ops  # noqa: F401  (every ops/cuda_*.py declares its entry points)
from yololp_tpu_torch.ops import _build, cuda_conv, cuda_matmul


def _tree(root, header: str):
    csrc = root / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return G; }\n')
    (csrc / "shared.cuh").write_text(header)
    return csrc


def test_an_edited_header_gives_a_new_library(tmp_path):
    a = _tree(tmp_path / "a", "#define G 1\n")
    b = _tree(tmp_path / "b", "#define G 2\n")
    same = _tree(tmp_path / "c", "#define G 1\n")
    assert _build._lib_path("k", a) != _build._lib_path("k", b)
    assert _build._lib_path("k", a) == _build._lib_path("k", same)
    assert _build._lib_path("k", a).name.startswith("libk_")


def test_the_flags_are_part_of_the_library_name(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, "#define G 1\n")
    before = _build._lib_path("k", csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DEXTRA"])
    assert _build._lib_path("k", csrc) != before


def test_every_shipped_source_hashes_the_shared_header():
    assert (_build.CSRC / "hopper_gemm.cuh").is_file()
    assert {"int8_conv", "mxu_matmul", "greedy_nms"} <= set(_build.sources())
    for name in ("int8_conv", "mxu_matmul"):
        assert '#include "hopper_gemm.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def test_ptxas_usage_reads_each_kernel_instance():
    _build.PTXAS_REPORT["_t"] = (
        "ptxas info    : Compiling entry function "
        "'_ZN46_GLOBAL__N__45ff7259_12_int8_conv_cu_b580f90e16int8_conv_kernelILi128ELi0ELb1EEEvPKa'"
        " for 'sm_90a'\n"
        "    0 bytes stack frame, 4 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 154 registers, used 1 barriers, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117mxu_matmul_kernelIN2hg4Bf16ELi64ELb1EEEv' for 'sm_90a'\n"
        "ptxas info    : Used 90 registers, 16 bytes smem, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN46_GLOBAL__N__938e7a34_13_greedy_nms_cu_3e409dda17greedy_nms_kernelEPK6float4' for 'sm_90a'\n"
        "ptxas info    : Used 24 registers, 380 bytes cmem[0]\n")
    try:
        usage = _build.ptxas_usage("_t")
    finally:
        del _build.PTXAS_REPORT["_t"]
    assert usage == [
        dict(entry="int8_conv_kernel<128,0,1>", registers=154, smem_bytes=0, spill_bytes=4),
        dict(entry="mxu_matmul_kernel<Bf16,64,1>", registers=90, smem_bytes=16, spill_bytes=0),
        dict(entry="greedy_nms_kernel", registers=24, smem_bytes=0, spill_bytes=0)]


@pytest.mark.parametrize("dtype,k", [(torch.int8, 24), (torch.int8, 32), (torch.bfloat16, 12),
                                     (torch.bfloat16, 8), (torch.int8, 216)])
def test_rows16_pads_only_rows_that_do_not_start_on_16_bytes(dtype, k):
    t = torch.arange(5 * k).reshape(5, k).to(dtype)
    rows, ld = cuda_matmul.rows16(t)
    assert torch.equal(rows, t) and rows.stride() == (ld, 1)
    assert (ld * t.element_size()) % 16 == 0 and rows.data_ptr() % 16 == 0
    assert (rows is t) == ((k * t.element_size()) % 16 == 0)
    # a transposed view is copied K-major
    rows_t, ld_t = cuda_matmul.rows16(t.t())
    assert torch.equal(rows_t, t.t()) and rows_t.stride(1) == 1


def test_a_conv_tap_view_is_taken_as_it_is():
    w = torch.zeros(48, 3, 3, 32, dtype=torch.int8)
    assert cuda_matmul.rows16_ok(w[:, 2, 1, :])  # rows 288 bytes apart
    assert not cuda_matmul.rows16_ok(torch.zeros(48, 3, 3, 24, dtype=torch.int8)[:, 0, 0, :])


def test_the_cpu_path_builds_no_weight_map():
    # weight maps exist only for the kernel; the CPU runs the plain version
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 3, 3, 16, dtype=torch.int8)
    a = torch.ones(8)
    before = len(cuda_conv._WEIGHT_MAPS)
    cuda_conv.int8_conv(x, w, a, a)
    assert len(cuda_conv._WEIGHT_MAPS) == before


# a C parameter's or return type's ctypes type: every pointer (and the
# stream, a pointer) c_void_p
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "double": ctypes.c_double, "void": None}


def c_prototype(lib: str, symbol: str):
    """([argument types], return type) of `extern "C"` `symbol` in
    csrc/<lib>.cu, as ctypes must declare them."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" (\w+) ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"csrc/{lib}.cu defines no extern \"C\" {symbol}"
    args = []
    for param in m.group(2).split(","):
        words = param.replace("const ", "").split()
        ptr = "*" in param or words[0] == "cudaStream_t"
        args.append(ctypes.c_void_p if ptr else C_TYPES[" ".join(words[:-1])])
    return args, C_TYPES[m.group(1)]


class StandIn:
    """A ctypes function's stand-in: counts the assignments of its types
    and refuses a call before they are set."""

    def __init__(self):
        object.__setattr__(self, "set", [])
        object.__setattr__(self, "calls", 0)

    def __setattr__(self, name, value):
        self.set.append(name)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        assert {"argtypes", "restype"} <= set(self.set), "called before it was bound"
        object.__setattr__(self, "calls", self.calls + 1)
        return 0


@pytest.mark.parametrize("symbol", sorted(_build.ENTRIES))
def test_every_entry_point_is_bound_once_before_its_first_call(symbol, monkeypatch):
    """ctypes passes an unbound Python int as a 32-bit C int, which cuts a
    device pointer: each entry point the port calls is bound before its first
    call, and only then, with its C prototype's types (every pointer
    c_void_p); the launches add the device and the stream."""
    entry = _build.ENTRIES[symbol]
    fn, loads = StandIn(), []
    monkeypatch.setattr(_build, "load",
                        lambda name: loads.append(name) or types.SimpleNamespace(**{symbol: fn}))
    monkeypatch.setattr(entry, "fn", None)
    args = [0] * len(entry.argtypes)
    entry(*args)
    entry(*args)
    assert loads == [entry.lib] and fn.set == ["argtypes", "restype"] and fn.calls == 2
    assert (fn.argtypes, fn.restype) == c_prototype(entry.lib, symbol)


def test_every_kernel_declares_its_launch_entry_point():
    """Every kernel's `*_launch` of csrc/ is declared, and every declared
    entry point is an `extern "C"` function of the source it names."""
    externs = {m.group(1): p.stem for p in _build.CSRC.glob("*.cu")
               for m in re.finditer(r'extern "C" \w+ (\w+)\(', p.read_text())}
    assert {s for s in externs if s.endswith("_launch")} <= set(_build.ENTRIES)
    assert {s: e.lib for s, e in _build.ENTRIES.items()} == {s: externs.get(s)
                                                              for s in _build.ENTRIES}
