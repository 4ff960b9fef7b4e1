"""Cycles a step of K4's cascade (``d3d_tpu_torch/csrc/soft_nms.cu``) on
the card, by phase, from ``clock64()`` reads inserted into a copy of the
source::

    python3 scripts/probe_soft_nms.py

It writes the instrumented copy to ``build/probe/``, compiles it with
``nvcc`` as ``ops/_build.py`` compiles K4 and runs it on the soft-NMS
path's input (the north star's 512 boxes, ``chip_smoke.py``), linear and
gaussian. Thread 0 of the cascade sums, over the steps, the cycles from a
step's start to its pick (the argmax), from the pick to the rescan (the
updates of the marked boxes) and of the rescan of the touched groups; it
prints them a step with the step count. A phase's cycles include the time
thread 0 waits there for lanes on another path.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe"

BEST_OF = "    best_of<C, kLanes>(avail, s_kk, g, j0, dirty, gk, gs, bk, bi);\n"

WRITE_BACK = ("#pragma unroll\n  for (int k = 0; k < C; ++k)\n"
              "    if (j0 + k < n) suppressed")

# (anchor in soft_nms.cu, text inserted in its place)
PROBES = [
    ("namespace {\n",
     "__device__ unsigned long long g_prof[8];\nnamespace {\n"),
    ("  for (int step = 0; step < n; ++step) {\n",
     "  unsigned long long a0 = 0, a1 = 0, a2 = 0, ns = 0;\n"
     "  const long long t0 = clock64();\n"
     "  for (int step = 0; step < n; ++step) {\n"
     "    const long long c0 = clock64();\n"),
    ("    const int pick = key == kNanKey ? n - 1 : idx;\n",
     "    const int pick = key == kNanKey ? n - 1 : idx;\n"
     "    const long long c1 = clock64();\n    a0 += c1 - c0;\n    ++ns;\n"),
    (BEST_OF,
     "    const long long c2 = clock64();\n    a1 += c2 - c1;\n" + BEST_OF
     + "    a2 += clock64() - c2;\n"),
    (WRITE_BACK,
     "  if (tid == 0) {\n    g_prof[0] = a0;\n    g_prof[1] = a1;\n"
     "    g_prof[2] = a2;\n    g_prof[3] = clock64() - t0;\n"
     "    g_prof[4] = ns;\n  }\n"
     + WRITE_BACK),
]


def main():
    if not torch.cuda.is_available():
        print("probe_soft_nms: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from d3d_tpu_torch.ops import _build, geometry_cuda, nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    src = (_build.CSRC / "soft_nms.cu").read_text()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe_soft_nms: anchor not found once: "
                             f"{anchor!r}")
        src = src.replace(anchor, text)
    src += ('\nextern "C" int probe_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
            'sizeof(g_prof));\n}\n')
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "soft_nms_probe.cu").write_text(src)
    lib_path = OUT / "libsoft_nms_probe.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS,
                    *_build._LIBRARIES["soft_nms"][1], "-o", str(lib_path),
                    str(OUT / "soft_nms_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.d3d_soft_nms_scan.argtypes = _build._LIBRARIES["soft_nms"][2][
        "d3d_soft_nms_scan"]
    lib.probe_read.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    _, boxes, scores = cs.north_star_frame()
    tb = torch.from_numpy(boxes).to(dev)
    iou = geometry_cuda.rbox_iou_matrix(tb, tb)
    pre, init = _soft_nms_init(torch.from_numpy(scores).to(dev),
                               cs.SOFT_NMS_ARGS["score_threshold"])
    n = tb.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = torch.empty(nms_cuda._soft_scratch_words(n), dtype=torch.int32,
                          device=dev)
    print(cs.card_line())
    prof = (ctypes.c_ulonglong * 8)()
    for method, param in cs.SOFT_NMS_CASES:
        for _ in range(3):
            err = lib.d3d_soft_nms_scan(
                iou.data_ptr(), init.data_ptr(), pre.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), scratch.numel(), n,
                cs.SOFT_NMS_ARGS["iou_threshold"],
                cs.SOFT_NMS_ARGS["score_threshold"], param,
                nms_cuda._SOFT_METHODS[method], _build.stream_handle(dev))
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"probe_soft_nms: CUDA error {err}")
        lib.probe_read(prof)
        argmax, update, rescan, total, steps = list(prof)[:5]
        print(f"{method}: {steps} steps, cycles a step: argmax "
              f"{argmax / steps:.0f}, updates {update / steps:.0f}, rescan "
              f"{rescan / steps:.0f}, whole step {total / steps:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
