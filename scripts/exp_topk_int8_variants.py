"""Development probe of the int8 top-k's tensor-core scan (``mma`` route of
``comorag_torch/csrc/mips_topk.cu``) on one CUDA card: textual variants of
the source are built beside it and timed at chip_smoke.py phase 6's shape
(100,000 x 1024 int8 rows, k = 50, P = 16 and 256) through their C entries.

    python scripts/exp_topk_int8_variants.py [--variants noselect noproducts clocks]
        [--other-src FILE] [--dry]

Variants (each a probe, not a design: ``noselect`` and ``noproducts``
give wrong top-k lists):
- ``noselect``: no appends and no merges (products and streaming alone);
- ``noproducts``: no mma.sync products (streaming and selection alone);
- ``clocks``: clock64 per tile of a block, products against selection,
  and the final merges, summed over blocks (thread 0 of each block);
- ``stages2``, ``stages4``, ``stages5``: that many stages in the TMA ring;
- ``rows32``: 4 warps of 32 rows (two m16 tiles) in place of 8 of 16;
- ``nocopy``, ``noquerycopy``: no TMA copies at all, or none of the
  query boxes (the stages are read as they are: wrong results);
- ``noconvert``: int8 words used as bf16 pairs without the conversion;
- ``lag``, ``lag_stages4``: thread 0 refills the stage of the chunk
  before the one it just read (its wait then finds the other warps
  done), with 3 or 4 stages;
- ``testwait``, ``hintwait``: the kernel's barrier waits spin on
  ``mbarrier.test_wait`` (no suspend), or ``try_wait`` with a 32 ns
  suspend hint, in place of ``try_wait``'s default;
- ``clocks_<probe>``: ``clocks`` on top of that probe;
- ``--other-src FILE``: another version of mips_topk.cu, timed beside.
Prints, per P, the median ms (chip_smoke's ``median_ms``) of each build
and whether its result holds ops/mips.check_topk's rule, then the
profiler's device time per kernel of the current build and the card's
nvidia-smi name and power limit. ``--dry`` only builds the variant texts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import BENCH_K, bench_data, median_ms, nvidia_smi_line  # noqa: E402
from comorag_torch.ops import build, mips  # noqa: E402
from comorag_torch.ops.topk import int8_scores, quantize_int8  # noqa: E402

KERNEL = "mma_scan_kernel(const __grid_constant__"


def after(src: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` after the mma kernel's start replaced."""
    i = src.find(old, src.index(KERNEL))
    if i < 0:
        raise ValueError(f"variant anchor not found: {old[:60]!r}")
    return src[:i] + new + src[i + len(old):]


def clocks(src: str) -> str:
    v = after(src, "  int c = 0;\n  for (int t0 = row0; t0 < row_end; t0 += WBN) {\n",
              "  int c = 0;\n  long long T[4] = {0, 0, 0, 0};\n"
              "  for (int t0 = row0; t0 < row_end; t0 += WBN) {\n    const long long k0 = clock64();\n")
    v = after(v, "    // appends against the threshold", "    const long long k1 = clock64();\n    // appends against the threshold")
    v = after(v, "      __syncthreads();\n    }\n  }\n  for (int qq = warp; qq < nq; qq += WARPS_M) {",
              "      __syncthreads();\n    }\n    T[0] += k1 - k0; T[1] += clock64() - k1; T[3] += 1;\n  }\n"
              "  const long long k5 = clock64();\n  for (int qq = warp; qq < nq; qq += WARPS_M) {")
    v = after(v, "  __syncthreads();\n\n  for (int qq = 0; qq < nq; ++qq) {",
              "  __syncthreads();\n  T[2] += clock64() - k5;\n"
              "  if (tid == 0) for (int z = 0; z < 4; ++z) atomicAdd(&DBG[z], (unsigned long long)T[z]);\n\n"
              "  for (int qq = 0; qq < nq; ++qq) {")
    v = v.replace("__global__ void __launch_bounds__(MTHREADS, WBLOCKS_PER_SM)\nmma_scan_kernel",
                  "__device__ unsigned long long DBG[4];\n"
                  "__global__ void __launch_bounds__(MTHREADS, WBLOCKS_PER_SM)\nmma_scan_kernel")
    return v + ('\nextern "C" int dbg_read(unsigned long long* out) {\n'
                "  cudaMemcpyFromSymbol(out, DBG, 32);\n  unsigned long long z[4] = {0, 0, 0, 0};\n"
                "  return cudaMemcpyToSymbol(DBG, z, 32);\n}\n")


def spin_waits(src: str, wait_asm: str) -> str:
    """The mma kernel's barrier waits as a loop of ``wait_asm``."""
    fn = ("__device__ __forceinline__ void probe_wait(uint64_t* bar, uint32_t parity) {\n"
          "  const uint32_t addr = comorag::smem_u32(bar);\n  uint32_t done = 0;\n"
          "  while (!done) asm volatile(\"{\\n.reg .pred p;\\n" + wait_asm + "\\nselp.u32 %0, 1, 0, p;\\n}\\n\"\n"
          "      : \"=r\"(done) : \"r\"(addr), \"r\"(parity) : \"memory\");\n}\n\n")
    i = src.index("__global__ void __launch_bounds__(MTHREADS, WBLOCKS_PER_SM)")
    body = src[i:].replace("comorag::mbar_wait(", "probe_wait(", 2)
    return src[:i] + fn + body


MAKERS = {
    "noselect": lambda s: after(s, "    for (;;) {\n#pragma unroll", "    pending = 0;\n    for (;;) {\n#pragma unroll"),
    "noproducts": lambda s: after(s, "comorag::mma_bf16(acc[mi][nj], a[mi],", "if (k < 0) comorag::mma_bf16(acc[mi][nj], a[mi],"),
    "clocks": clocks,
    "stages2": lambda s: s.replace("constexpr int MSTAGES = 3;", "constexpr int MSTAGES = 2;"),
    "stages4": lambda s: s.replace("constexpr int MSTAGES = 3;", "constexpr int MSTAGES = 4;"),
    "stages5": lambda s: s.replace("constexpr int MSTAGES = 3;", "constexpr int MSTAGES = 5;"),
    "rows32": lambda s: s.replace("constexpr int MMI = 1;", "constexpr int MMI = 2;"),
    "nocopy": lambda s: s.replace("""    comorag::mbar_expect_tx(bar, MSTAGE);
    comorag::tma_load_2d(st, &qmap, bar, f0, qb0);
    comorag::tma_load_2d(st + MQ_BYTES, &xmap, bar, f0, row0 + (c / chunks) * WBN);""",
                                  """    comorag::mbar_arrive(bar);"""),
    "noquerycopy": lambda s: s.replace("""    comorag::mbar_expect_tx(bar, MSTAGE);
    comorag::tma_load_2d(st, &qmap, bar, f0, qb0);""", """    comorag::mbar_expect_tx(bar, MX_BYTES);"""),
    "noconvert": lambda s: s.replace(
        "__device__ __forceinline__ void int8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {",
        "__device__ __forceinline__ void int8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {\n"
        "  lo = w; hi = w ^ 0x80808080u; return;"),
    "lag": lambda s: after(s, """      if (tid == 0 && c + MSTAGES < total) {  // refill the stage once every warp has read it
        comorag::mbar_wait(&empty[slot], parity);
        issue(c + MSTAGES);
      }""", """      if (tid == 0 && c >= 1 && c - 1 + MSTAGES < total) {
        comorag::mbar_wait(&empty[(c - 1) % MSTAGES], ((c - 1) / MSTAGES) & 1);
        issue(c - 1 + MSTAGES);
      }"""),
    "testwait": lambda s: spin_waits(s, "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;"),
    "hintwait": lambda s: spin_waits(s, "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 32;"),
}
MAKERS["lag_stages4"] = lambda s: MAKERS["lag"](MAKERS["stages4"](s))
for _name in ("noproducts", "nocopy", "noconvert", "testwait", "lag"):
    MAKERS[f"clocks_{_name}"] = (lambda n: lambda s: clocks(MAKERS[n](s)))(_name)


def compile_variant(name: str, text: str, out_dir: str):
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(json.dumps({"build_failed": name, "stderr": proc.stderr[-1500:]}), flush=True)
        return None
    lib = ctypes.CDLL(so)
    lib.comorag_error_string.restype = ctypes.c_char_p
    lib.comorag_error_string.argtypes = [ctypes.c_int]
    lib.comorag_mips_topk_int8.restype = ctypes.c_int
    lib.comorag_mips_topk_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    lib.comorag_mips_topk_workspace_bytes.restype = ctypes.c_longlong
    lib.comorag_mips_topk_workspace_bytes.argtypes = [ctypes.c_int] * 5
    return lib


def caller(lib: ctypes.CDLL, q, cq, sc, k: int, device):
    """One mma-route launch of ``lib`` on buffers made here."""
    (p, d), n = q.shape, cq.shape[0]
    sms = mips._sm_count(device)
    ws = torch.empty(lib.comorag_mips_topk_workspace_bytes(p, n, d, k, sms), dtype=torch.uint8, device=device)
    out_s = torch.empty((p, k), device=device)
    out_i = torch.empty((p, k), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def call():
        rc = lib.comorag_mips_topk_int8(q.data_ptr(), cq.data_ptr(), sc.data_ptr(), p, n, d, k,
                                        mips.SCAN_ROUTES.index("mma"), sms, ws.data_ptr(), out_s.data_ptr(),
                                        out_i.data_ptr(), stream)
        build.check(lib, rc, "mips_topk_int8 variant")
        return out_s, out_i
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", choices=sorted(MAKERS), default=[])
    ap.add_argument("--other-src", help="another version of csrc/mips_topk.cu to time beside")
    ap.add_argument("--dry", action="store_true", help="build the variant texts only")
    args = ap.parse_args()
    with open(os.path.join(build.CSRC_DIR, "mips_topk.cu")) as f:
        src = f.read()
    texts = {"current": src, **{name: MAKERS[name](src) for name in args.variants}}
    if args.other_src:
        with open(args.other_src) as f:
            texts["other"] = f.read()
    if args.dry:
        print(json.dumps({name: len(t) for name, t in texts.items()}))
        return
    if not torch.cuda.is_available():
        raise SystemExit("exp_topk_int8_variants: needs a CUDA card")
    device = torch.device("cuda", 0)
    print(nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="topk_variants_") as out_dir, ThreadPoolExecutor(len(texts)) as pool:
        libs = {name: lib for name, lib in zip(texts, pool.map(lambda kv: compile_variant(*kv, out_dir),
                                                                 texts.items())) if lib is not None}
        corpus, queries = bench_data(256)
        cq, sc = (torch.tensor(a, device=device) for a in quantize_int8(corpus))
        del corpus
        for p in (16, 256):
            q = torch.tensor(queries[:p], device=device)
            scores = int8_scores(q, cq, sc)
            row = {"P": p}
            for name, lib in libs.items():
                call = caller(lib, q, cq, sc, BENCH_K, device)
                s, i = call()
                torch.cuda.synchronize()
                try:
                    mips.check_topk(s, i, scores, name)
                    holds = True
                except AssertionError:
                    holds = False
                row[name] = {"ms": median_ms(call), "holds_check_topk": holds}
            print(json.dumps(row), flush=True)
            for clocked in [n for n in libs if n.startswith("clocks")]:
                lib = libs[clocked]
                buf = (ctypes.c_ulonglong * 4)()
                lib.dbg_read.argtypes = [ctypes.c_void_p]
                lib.dbg_read(buf)
                caller(lib, q, cq, sc, BENCH_K, device)()
                torch.cuda.synchronize()
                lib.dbg_read(buf)
                t = list(buf)
                print(json.dumps({"P": p, "build": clocked, "cycles_per_block_tile": {"products": t[0] / t[3], "selection": t[1] / t[3],
                                                                    "final_merges": t[2] / t[3]},
                                  "block_tiles": t[3]}), flush=True)
            call = caller(libs["current"], q, cq, sc, BENCH_K, device)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            print(json.dumps({"P": p, "device_us_per_call": {e.key.split("(")[0][-40:]: e.device_time_total / 10
                                                             for e in prof.key_averages()
                                                             if e.device_time_total > 0}}), flush=True)


if __name__ == "__main__":
    main()
