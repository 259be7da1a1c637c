"""Development probe of the top-k's tensor-core scans (the ``mma`` route
over int8 rows and the ``tf32`` route over fp32 rows of
``comorag_torch/csrc/mips_topk.cu``) on one CUDA card: textual variants of
the source are built beside it and timed at chip_smoke.py phase 6's shape
(100,000 x 1024 rows, k = 50, P = 16, 32 and 256) through their C entries.

    python scripts/exp_topk_variants.py [--rows int8|fp32] [--variants noselect noproducts clocks]
        [--other-src FILE] [--dry]

Variants (each a probe, not a design: ``noselect``, ``noproducts``,
``nocopy`` and ``nosplit`` give wrong top-k lists):
- ``noselect``: no appends and no merges (ptxas then deletes the products
  too, whose sums nothing reads: streaming alone);
- ``noproducts``: no mma.sync products (streaming and selection alone);
- ``clocks``: clock64 per tile of a block, products against selection,
  and the final merges, summed over blocks (thread 0 of each block);
- ``nocopy``: no TMA copies (the stages are read as they are);
- ``tbk16_s3``, ``tbk16_s4``, ``tbk16_s5``: the tf32 scan's stages of 16
  features (64-byte rows, unswizzled) in a ring of 3, 4 or 5;
- ``tf32_s1``: the tf32 scan's ring of one 32-feature stage (a probe of
  the ring's depth);
- ``onesum``: the tf32 scan's cross terms (lo.hi, hi.lo) summed into the
  hi.hi accumulator before hi.hi (CUTLASS's order), not into a second one;
- ``nosplit``: the tf32 scan's rows taken as they are for hi, with lo 0
  (no split at fragment load);
- ``inline_merge``: the register merge inlined at both of its call
  sites, not one called function;
- ``onemma``: the tf32 scan's hi.hi product alone (no cross terms);
- ``sinkacc``, ``sinkacc_onemma``, ``sinkacc_nosplit``: no selection, but
  every sum consumed (``noselect`` lets ptxas delete the products whose
  sums nothing reads), alone or on top of that probe;
- ``blocks1_s4``, ``blocks1_s6``: one tensor-core scan block an SM (no
  register cap of 128) with a tf32 ring of 4 or 6 stages;
- ``clocks_<probe>``: ``clocks`` on top of any other probe;
- ``--other-src FILE``: another version of mips_topk.cu, timed beside.
Prints, per P, the median ms (chip_smoke's ``median_ms``) of each build,
its max |score - plain| and whether its result holds ops/mips.check_topk's
rule, then the profiler's device time per kernel of the current build and
the card's nvidia-smi name and power limit. ``--dry`` only builds the
variant texts.
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
from comorag_torch.ops.topk import dense_scores, int8_scores, quantize_int8  # noqa: E402

ANCHOR = "template <class Release>\n__device__ __forceinline__ void chunk_products("  # the scans' device code


def after(src: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` after the scans' device code starts replaced."""
    i = src.find(old, src.index(ANCHOR))
    if i < 0:
        raise ValueError(f"variant anchor not found: {old[:60]!r}")
    return src[:i] + new + src[i + len(old):]


def before_scans(src: str, text: str) -> str:
    """``src`` with ``text`` inserted before the scans' device code."""
    i = src.index(ANCHOR)
    return src[:i] + text + src[i:]


def replaced(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"variant anchor found {src.count(old)} times, not {count}: {old[:60]!r}")
    return src.replace(old, new)


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
    v = before_scans(v, "__device__ unsigned long long DBG[4];\n\n")
    return v + ('\nextern "C" int dbg_read(unsigned long long* out) {\n'
                "  cudaMemcpyFromSymbol(out, DBG, 32);\n  unsigned long long z[4] = {0, 0, 0, 0};\n"
                "  return cudaMemcpyToSymbol(DBG, z, 32);\n}\n")


def one_sum(src: str) -> str:
    """The tf32 products' cross terms summed into the hi.hi accumulator
    before hi.hi (CUTLASS's 3xTF32 order) instead of a second sum."""
    return replaced(src, "            comorag::mma_tf32(cross[mi][nj], alo[mi], h[0], h[1]);\n"
                         "            comorag::mma_tf32(cross[mi][nj], ahi[mi], l[0], l[1]);\n",
                    "            comorag::mma_tf32(acc[mi][nj], alo[mi], h[0], h[1]);\n"
                    "            comorag::mma_tf32(acc[mi][nj], ahi[mi], l[0], l[1]);\n")


def tf32_stages(src: str, n: int) -> str:
    return replaced(src, "constexpr int TSTAGES = 2;", f"constexpr int TSTAGES = {n};")


STAGE_LOADS = """    comorag::mbar_expect_tx(bar, STAGE);
    comorag::tma_load_3d(st, &qmap, bar, f0, qb0, 0);
"""
MAKERS = {
    "noselect": lambda s: after(s, "    for (;;) {\n#pragma unroll", "    pending = 0;\n    for (;;) {\n#pragma unroll"),
    "noproducts": lambda s: replaced(replaced(s, "comorag::mma_bf16(acc[mi][nj], a[mi],",
                                              "if (q_tiles < 0) comorag::mma_bf16(acc[mi][nj], a[mi],"),
                                     "comorag::mma_tf32(", "if (q_tiles < 0) comorag::mma_tf32(", 3),
    "clocks": clocks,
    "nocopy": lambda s: replaced(s, STAGE_LOADS + "    comorag::tma_load_2d(st + ST::Q_BYTES, &xmap, bar, f0, row0 + (c / chunks) * WBN);",
                                 "    comorag::mbar_arrive(bar);"),
    "tf32_s1": lambda s: tf32_stages(s, 1),
    "onesum": one_sum,
    "nosplit": lambda s: replaced(
        s, "          comorag::split_tf32(reinterpret_cast<const float*>(&x[mi][e & 1])[2 * s + (e >> 1)], ahi[mi][e], "
           "alo[mi][e]);",
        "          { ahi[mi][e] = __float_as_uint(reinterpret_cast<const float*>(&x[mi][e & 1])[2 * s + (e >> 1)]); "
        "alo[mi][e] = 0u; }"),
    "inline_merge": lambda s: replaced(s, "template <int KMAX>\n__device__ __noinline__ void warp_merge_regs(",
                                       "template <int KMAX>\n__device__ void warp_merge_regs("),
    "onemma": lambda s: replaced(s, "            comorag::mma_tf32(cross[mi][nj], alo[mi], h[0], h[1]);\n"
                                    "            comorag::mma_tf32(cross[mi][nj], ahi[mi], l[0], l[1]);\n", ""),
}
# the selection's appends and merges left out, every sum still consumed (so
# that ptxas keeps the products: without a use of the sums it deletes them)
MAKERS["sinkacc"] = lambda s: after(MAKERS["noselect"](s), "    // appends against the threshold",
                                    "    {\n      float z = 0.f;\n      for (int mi = 0; mi < MMI; ++mi)\n"
                                    "        for (int nj = 0; nj < 4; ++nj)\n"
                                    "          for (int e = 0; e < 4; ++e) z += acc[mi][nj][e];\n"
                                    "      if (z == 1.2345e30f) th_s[0] = z;\n    }\n"
                                    "    // appends against the threshold")
MAKERS["sinkacc_onemma"] = lambda s: MAKERS["sinkacc"](MAKERS["onemma"](s))
MAKERS["sinkacc_nosplit"] = lambda s: MAKERS["sinkacc"](MAKERS["nosplit"](s))
for _n in (4, 6):
    MAKERS[f"blocks1_s{_n}"] = (lambda n: lambda s: tf32_stages(
        replaced(s, "constexpr int WBLOCKS_PER_SM = 2;", "constexpr int WBLOCKS_PER_SM = 1;"), n))(_n)
for _n in (3, 4, 5):
    MAKERS[f"tbk16_s{_n}"] = (lambda n: lambda s: replaced(
        replaced(s, "constexpr int TBK = 32;", "constexpr int TBK = 16;"),
        "constexpr int TSTAGES = 2;", f"constexpr int TSTAGES = {n};"))(_n)
for _name in [n for n in MAKERS if n != "clocks"]:
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
    for fn in (lib.comorag_mips_topk, lib.comorag_mips_topk_int8):
        fn.restype = ctypes.c_int
    lib.comorag_mips_topk.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    lib.comorag_mips_topk_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    lib.comorag_mips_topk_workspace_bytes.restype = ctypes.c_longlong
    lib.comorag_mips_topk_workspace_bytes.argtypes = [ctypes.c_int] * 5
    return lib


def caller(lib: ctypes.CDLL, q, rows: tuple, k: int, device):
    """One tensor-core-route launch of ``lib`` on buffers made here: the
    ``tf32`` route for (fp32 rows,), ``mma`` for (int8 rows, scales)."""
    (p, d), n = q.shape, rows[0].shape[0]
    sms = mips._sm_count(device)
    ws = torch.empty(lib.comorag_mips_topk_workspace_bytes(p, n, d, k, sms), dtype=torch.uint8, device=device)
    out_s = torch.empty((p, k), device=device)
    out_i = torch.empty((p, k), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if len(rows) == 1:
        head = (lib.comorag_mips_topk, q.data_ptr(), rows[0].data_ptr(), 0)
    else:
        head = (lib.comorag_mips_topk_int8, q.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr())
    route = mips.SCAN_ROUTES.index("tf32" if len(rows) == 1 else "mma")

    def call():
        rc = head[0](*head[1:], p, n, d, k, route, sms, ws.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
        build.check(lib, rc, "top-k variant")
        return out_s, out_i
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", choices=("int8", "fp32"), default="int8",
                    help="int8 rows (the mma route) or fp32 rows (the tf32 route)")
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
        raise SystemExit("exp_topk_variants: needs a CUDA card")
    device = torch.device("cuda", 0)
    print(nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="topk_variants_") as out_dir, ThreadPoolExecutor(len(texts)) as pool:
        libs = {name: lib for name, lib in zip(texts, pool.map(lambda kv: compile_variant(*kv, out_dir),
                                                                 texts.items())) if lib is not None}
        corpus, queries = bench_data(256)
        if args.rows == "fp32":
            rows = (torch.tensor(corpus, device=device),)
            c64 = rows[0].double()
        else:
            rows = tuple(torch.tensor(a, device=device) for a in quantize_int8(corpus))
            c64 = (rows[0].double() * rows[1].double()[:, None])
        del corpus
        for p in (16, 32, 256):
            q = torch.tensor(queries[:p], device=device)
            scores = dense_scores(q, rows[0]) if args.rows == "fp32" else int8_scores(q, *rows)
            # the float64 score of each returned id (int8: the queries rounded to bf16, as the kernel takes them)
            q64 = (q if args.rows == "fp32" else q.to(torch.bfloat16)).double()
            row = {"P": p, "rows": args.rows}
            for name, lib in libs.items():
                call = caller(lib, q, rows, BENCH_K, device)
                s, i = call()
                torch.cuda.synchronize()
                try:
                    err = mips.check_topk(s, i, scores, name)
                except AssertionError:
                    err = None
                # a probe's lists may hold empty slots (ids out of range): no float64 error then
                vs64 = None
                if err is not None:
                    vs64 = float((s.double() - torch.einsum("pd,pkd->pk", q64, c64[i])).abs().max())
                row[name] = {"ms": median_ms(call), "holds_check_topk": err is not None, "max_abs_err_vs_plain": err,
                             "max_abs_err_vs_float64": vs64}
            print(json.dumps(row), flush=True)
            for clocked in [n for n in libs if n.startswith("clocks")]:
                lib = libs[clocked]
                buf = (ctypes.c_ulonglong * 4)()
                lib.dbg_read.argtypes = [ctypes.c_void_p]
                lib.dbg_read(buf)
                caller(lib, q, rows, BENCH_K, device)()
                torch.cuda.synchronize()
                lib.dbg_read(buf)
                t = list(buf)
                print(json.dumps({"P": p, "build": clocked, "cycles_per_block_tile": {"products": t[0] / t[3], "selection": t[1] / t[3],
                                                                    "final_merges": t[2] / t[3]},
                                  "block_tiles": t[3]}), flush=True)
            call = caller(libs["current"], q, rows, BENCH_K, device)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            print(json.dumps({"P": p, "device_us_per_call": {e.key.split("(")[0][-40:]: e.device_time_total / 10
                                                             for e in prof.key_averages()
                                                             if e.device_time_total > 0}}), flush=True)


if __name__ == "__main__":
    main()
