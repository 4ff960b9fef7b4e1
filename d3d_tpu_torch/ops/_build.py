"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds. Libraries go to
``build/d3d_tpu_torch/`` beside the package, named by a hash of everything
that goes into them, so a changed source or flag never loads a stale build.
Nothing is built when a module is imported: :func:`load_library` builds on
first use, and :func:`build` builds several sources at once (one ``nvcc``
process each, all started together).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load_library", "stream_handle", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "d3d_tpu_torch"

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

# library -> (source, extra nvcc flags, {C function: argtypes}); every C
# function returns an int: a launch's cudaGetLastError(), or the answer of a
# query (d3d_subm_conv_tile_rows)
_LIBRARIES = {
    # -fmad=false: see the note on rounding at the top of rbox_iou.cu
    "rbox_iou": ("rbox_iou.cu", ["-fmad=false"],
                 {"d3d_rbox_iou_matrix": [_P, _P, _P, _I, _I, _P, _P],
                  "d3d_rbox_overlap_bits": [_P, _P, _I, _F, _P, _P],
                  "d3d_rbox_descriptors": [_P, _P, _I, _P]}),
    "nms_scan": ("nms_scan.cu", [],
                 {"d3d_nms_pack": [_P, _P, _I, _P],
                  "d3d_nms_scan": [_P, _P, _P, _F, _P, _P, _I, _P]}),
    # -fmad=false: see the note on rounding at the top of soft_nms.cu
    "soft_nms": ("soft_nms.cu", ["-fmad=false"],
                 {"d3d_soft_nms_scan": [_P, _P, _P, _P, _P, _L, _I, _F, _F,
                                        _F, _I, _P],
                  "d3d_soft_nms_scan_f64": [_P, _P, _P, _P, _P, _L, _I, _D,
                                            _D, _D, _I, _P]}),
    "subm_conv": ("subm_conv.cu", [],
                  {"d3d_subm_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _P],
                   "d3d_subm_conv_tile_rows": [_I],
                   "d3d_subm_conv_rulebook_resident": [],
                   "d3d_subm_conv_rulebook": [_P, _P, _I, _I, _P, _P, _P,
                                              _I, _P]}),
    "subm_conv_dw": ("subm_conv_dw.cu", [],
                     {"d3d_subm_conv_dw": [_P, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _I, _I, _I, _I, _I, _I,
                                           _P]}),
    "stage_maps": ("stage_maps.cu", [],
                   {"d3d_stage_maps": [_P, _P, _I, _P, _I, _P, _P, _L, _P]}),
    "bn_relu": ("bn_relu.cu", [],
                {"d3d_bn_relu": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _L,
                                 _L, _L, _L, _L, _P]}),
}

_lock = threading.Lock()
_loaded = {}


def _generated_headers():
    """Headers written into the build directory before compiling: the
    132-comparator sort network of K1 as compile-time index pairs, taken
    from the plain version's own list so the two cannot drift apart."""
    from .geometry_soa import _PAIRS24

    body = " \\\n    ".join(f"CE({i}, {j})" for i, j in _PAIRS24)
    return {"pairs24.cuh": (
        "// Generated by d3d_tpu_torch/ops/_build.py from\n"
        "// d3d_tpu_torch.ops.geometry_soa._PAIRS24; do not edit.\n"
        f"#define D3D_PAIRS24(CE) \\\n    {body}\n")}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _target(name, headers):
    source, extra, _ = _LIBRARIES[name]
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    for fname in sorted(headers):
        h.update(fname.encode() + headers[fname].encode())
    h.update(" ".join(_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, verbose=False):
    """Compile the named libraries (default: all) that are not built yet,
    all ``nvcc`` processes in parallel. Returns ``{name: compiler output}``
    (with ``verbose``, ``-Xptxas -v``'s registers, shared memory and
    spills per kernel)."""
    names = list(_LIBRARIES) if names is None else list(names)
    headers = _generated_headers()
    gen_dir = BUILD_DIR / "include"
    gen_dir.mkdir(parents=True, exist_ok=True)
    for fname, text in headers.items():
        path = gen_dir / fname
        if not path.exists() or path.read_text() != text:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, path)

    procs = {}
    for name in names:
        out = _target(name, headers)
        if out.exists():
            continue
        source, extra, _ = _LIBRARIES[name]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *extra, "-I", str(gen_dir),
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name):
    """The loaded :class:`ctypes.CDLL` of library ``name``, built on first
    use, with ``argtypes``/``restype`` declared for each C function."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = _target(name, _generated_headers())
            if not out.exists():
                build([name])
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in _LIBRARIES[name][2].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def stream_handle(device):
    """The raw handle of ``device``'s current CUDA stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a Stream object, a good part of a launch's host time: the
    smallest sparse-conv layers run shorter than their launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
