"""Cycles a chunk of the NMS scan's one-warp kernel
(``d3d_tpu_torch/csrc/nms_scan.cu`` ``scan_warp_kernel``) on the card, by
phase, from ``clock64()`` reads inserted into a copy of the source::

    python3 scripts/probe_nms_scan.py

It writes the instrumented copy to ``build/probe/``, compiles it with
``nvcc`` as ``ops/_build.py`` compiles the scan and runs it as ``nms2d``
does (K1's bit rows of the boxes in score order, the sorted scores, the
order) on the serving paths' 100 boxes and the north star's 512
(``chip_smoke.north_star_frame``) and on the nms2d-of-2048 path's boxes.
Lane 0 sums, over the chunks, the cycles of: the wait for the chunk's rows
and the staging of the next (``stage``, with the wait apart), the
resolution of the chunk's
alive rows (``resolve``: the warp's rounds, and the owner lane's steps where
they run out) and the ORs into the later words (``or``); it prints them a
chunk with the rounds a chunk, the chunks that fell back to the owner's
steps, and the cycles before the first chunk and after the last.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe"

LOOP = "  for (int c = 0; c < words; ++c) {\n    if (c > 0) {\n"
WAITED = ("      cp_async_wait_all();  // chunk c's rows\n"
          "      __syncwarp();\n    }\n")
CUR = "    const u64(*cur)[kWarpWords] = rows[c & 1];\n"
LATER = "    const int later = words - c - 1;  // warp-uniform\n"
DONE = ("    __syncwarp();  // every lane is done with rows[c & 1] before "
        "c + 2\n")
OUTPUT = "  // the mask: the words through shared memory, then a lane a box\n"
END = ("      suppressed[j] = static_cast<uint8_t>((sup[j >> 6] >> "
       "(j & 63)) & 1ull);\n  }\n}\n")
ROUND = "  for (int round = 0; round < kRounds; ++round) {\n"
FALLBACK = ("      // a long chain of suppressions: the owner lane's 64 "
            "steps\n")

# (anchor in nms_scan.cu, text inserted in its place)
PROBES = [
    ("namespace {\n",
     "__device__ unsigned long long g_prof[8];\nnamespace {\n"),
    ("  const int lane = threadIdx.x;\n  float* sneg",
     "  const int lane = threadIdx.x;\n"
     "  const long long t0 = clock64();\n"
     "  unsigned long long pa = 0, pb = 0, pc = 0, pw = 0;\n  float* sneg"),
    (LOOP, "  const long long t1 = clock64();\n" + LOOP.replace(
        "    if (c > 0) {\n",
        "    const long long c0 = clock64();\n    if (c > 0) {\n")),
    (WAITED, WAITED + "    pw += clock64() - c0;\n"),
    (CUR, "    const long long c1 = clock64();\n    pa += c1 - c0;\n" + CUR),
    (LATER,
     "    const long long c2 = clock64();\n    pb += c2 - c1;\n" + LATER),
    (DONE, "    pc += clock64() - c2;\n" + DONE),
    (OUTPUT, "  const long long t2 = clock64();\n" + OUTPUT),
    (END, END[:-2] + "  if (lane == 0) {\n    g_prof[0] = pa;\n"
     "    g_prof[1] = pb;\n    g_prof[2] = pc;\n    g_prof[3] = t1 - t0;\n"
     "    g_prof[4] = clock64() - t2;\n    g_prof[5] = pw;\n  }\n}\n"),
    (ROUND, ROUND + "    if (lane == 0) atomicAdd(&g_prof[6], 1ull);\n"),
    (FALLBACK,
     FALLBACK + "      if (lane == 0) atomicAdd(&g_prof[7], 1ull);\n"),
]


def main():
    if not torch.cuda.is_available():
        print("probe_nms_scan: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from d3d_tpu_torch.ops import _build, geometry_cuda

    src = (_build.CSRC / "nms_scan.cu").read_text()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe_nms_scan: anchor not found once: "
                             f"{anchor!r}")
        src = src.replace(anchor, text)
    src += ('\nextern "C" int probe_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
            'sizeof(g_prof));\n}\n'
            'extern "C" int probe_reset() {\n'
            '  unsigned long long zero[8] = {0};\n'
            '  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));\n'
            '}\n')
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "nms_scan_probe.cu").write_text(src)
    lib_path = OUT / "libnms_scan_probe.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS,
                    *_build._LIBRARIES["nms_scan"][1], "-o", str(lib_path),
                    str(OUT / "nms_scan_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.d3d_nms_scan.argtypes = _build._LIBRARIES["nms_scan"][2][
        "d3d_nms_scan"]
    lib.probe_read.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    _, boxes512, scores512 = cs.north_star_frame()
    boxes2048, scores2048 = cs.bench_boxes(np.random.default_rng(7), 2048)
    cases = {"n=100": (boxes512[:100], scores512[:100]),
             "n=512": (boxes512, scores512), "n=2048": (boxes2048,
                                                        scores2048)}
    print(cs.card_line())
    prof = (ctypes.c_ulonglong * 8)()
    for name, (b, s) in cases.items():
        tb = torch.from_numpy(b).to(dev)
        ts = torch.from_numpy(s).to(dev)
        neg, order = torch.sort(-ts, stable=True)
        bits = geometry_cuda._bits_launch(tb[order].contiguous(), 0.25)
        n = len(b)
        out = torch.empty(n, dtype=torch.bool, device=dev)
        for _ in range(3):
            lib.probe_reset()
            err = lib.d3d_nms_scan(bits.data_ptr(), None, neg.data_ptr(),
                                   0.0, order.data_ptr(), out.data_ptr(), n,
                                   _build.stream_handle(dev))
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"probe_nms_scan: CUDA error {err}")
        lib.probe_read(prof)
        stage, resolve, ors, before, after, wait, rounds, owner = list(prof)
        chunks = (n + 63) // 64
        print(f"{name}: {chunks} chunks, cycles a chunk: stage "
              f"{stage / chunks:.0f} (of which the wait for the chunk's rows "
              f"{wait / chunks:.0f}), resolve {resolve / chunks:.0f}, or "
              f"{ors / chunks:.0f}; before the first chunk {before}, after "
              f"the last {after}; rounds a chunk {rounds / chunks:.2f}, "
              f"chunks that fell back to the owner's steps {owner}; "
              f"{int((~out).sum())} kept")
    return 0


if __name__ == "__main__":
    sys.exit(main())
