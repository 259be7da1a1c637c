"""A/B timing of comorag_torch's encoder FFN, encoder attention, int4
matmul, int4 fused layer tail and fp32 and int8 top-k against an earlier version of
the same CUDA sources, in one process on one card.

    git archive <commit> comorag_torch/csrc | tar -x -C build/ab_old
    python scripts/torch_kernel_ab.py --old-csrc build/ab_old/comorag_torch/csrc \
        [--kernels ffn attention matmul tail topk]

The earlier sources are built with the same nvcc flags into the build
directory. Each kernel runs through the same wrapper for both (the library
is swapped under ``ops.ffn``, ``ops.attention`` and ``ops.int4``), except
where the earlier source has another C interface, which is then called
directly, with its workspaces made once outside the timed loop: a fused
tail with the first design's (commit a8e4f4b: no
``comorag_int4_tail_tile_n``) or with one pointer a weight (7e8341d and
before: no ``comorag_int4_tail_max_blocks``) and an FFN with the fused mma.sync design's
(up to commit 864f5f5: no ``comorag_encoder_ffn_tile``). int4_matmul
is timed at chip_smoke.py phase 9's six shapes through both libraries' C
entries, called directly (``matmul_ab``): the earlier library at the
current route where it has that entry, else at the one mma.sync kernel
of fdbff70 and before. The fp32 and int8 top-k (``topk_ab``) are timed at
chip_smoke.py phase 6's shape through both libraries' C entries, called
directly: the current one at ``ops.mips.scan_route``'s route, the earlier
one (dbd2d73's interface and routes: ``scan`` / ``wide`` for fp32 rows,
``mma`` for int8 rows) at the route dbd2d73's scan_route chose. Times are
medians of CUDA-event samples (chip_smoke's ``median_ms``), taken in
turns: earlier, current, current, earlier; int4_matmul at decode (M <= 64)
and the fused tail (where the earlier library has the current interface)
also give the host's microseconds a call in turns, as quartiles
(``host_in_turns``). Prints one JSON line per shape
and the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (BENCH_K, INT4_MATMUL_SHAPES, bench_data, device_ms, ffn_bound, ffn_inputs,  # noqa: E402
                        host_us, int4_bound, int4_matmul_dims, llama_8b, median_ms, nvidia_smi_line, ragged_mask,
                        route_of, rule_ratio, tail_bound)
from comorag_torch.ops import attention, build, ffn, int4, mips  # noqa: E402
from comorag_torch.ops.topk import dense_scores, int8_scores, quantize_int8  # noqa: E402


def build_old(csrc: str, name: str) -> ctypes.CDLL:
    out = os.path.join(build.BUILD_DIR, "ab_old")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{name}.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, os.path.join(csrc, f"{name}.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.comorag_error_string.restype = ctypes.c_char_p
    lib.comorag_error_string.argtypes = [ctypes.c_int]
    return lib


def in_turns(old, new) -> dict:
    t = [median_ms(old), median_ms(new), median_ms(new), median_ms(old)]
    return {"earlier_ms": [t[0], t[3]], "current_ms": [t[1], t[2]]}


def device_in_turns(old, new) -> dict:
    t = [device_ms(old), device_ms(new), device_ms(new), device_ms(old)]
    return {"earlier_device_ms": [t[0], t[3]], "current_device_ms": [t[1], t[2]]}


def host_in_turns(old, new, rounds: int = 25) -> dict:
    """The host's microseconds a call (chip_smoke's ``host_us``: 200 calls
    back to back, no sync) of each, taken in turns (earlier, current,
    current, earlier) ``rounds`` times: the quartiles of each one's
    2 x ``rounds`` samples, and of the current minus the earlier within a
    round (each round's mean of two against two)."""
    samples = {"earlier": [], "current": []}
    deltas = []
    for _ in range(rounds):
        t = [host_us(old), host_us(new), host_us(new), host_us(old)]
        samples["earlier"] += [t[0], t[3]]
        samples["current"] += [t[1], t[2]]
        deltas.append((t[1] + t[2] - t[0] - t[3]) / 2)

    def quartiles(v):
        return [float(q) for q in statistics.quantiles(v, n=4)]

    return {"earlier_host_us_quartiles": quartiles(samples["earlier"]),
            "current_host_us_quartiles": quartiles(samples["current"]),
            "current_minus_earlier_host_us_quartiles": quartiles(deltas)}


def through_wrapper(name: str, lib: ctypes.CDLL, fn):
    """``fn`` called with ``lib`` loaded under the wrapper of csrc/<name>.cu."""
    def call():
        build._libs[name] = lib
        return fn()
    return call


def attention_ab(old_lib: ctypes.CDLL, device) -> list:
    new_lib = attention._lib()
    fn = old_lib.comorag_encoder_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    rows = []
    for b, s in ((64, 512), (32, 32)):
        gen = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(b, s, 768, generator=gen).to(device).to(torch.bfloat16) for _ in range(3))
        for name, m in (("ragged", ragged_mask(b, s, gen, device)), ("full", torch.ones(b, s, dtype=torch.int32,
                                                                                       device=device))):
            def run():
                return attention.encoder_attention(q, k, v, m, 12)

            r = {"kernel": "encoder_attention", "shape": [b, s, 768], "heads": 12, "mask": name,
                 **in_turns(through_wrapper("encoder_attention", old_lib, run),
                            through_wrapper("encoder_attention", new_lib, run))}
            rows.append(r)
    build._libs["encoder_attention"] = new_lib
    return rows


def ffn_ab(old_lib: ctypes.CDLL, device) -> list:
    new_lib = ffn._lib()
    same_interface = hasattr(old_lib, "comorag_encoder_ffn_tile")
    if not same_interface:
        fn = old_lib.comorag_encoder_ffn_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        ws = old_lib.comorag_encoder_ffn_workspace_bytes
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for b, s in ((64, 512), (32, 32)):
        args = ffn_inputs(b * s, device)
        n, h, inter = b * s, args[0].shape[1], args[3].shape[1]
        out = torch.empty_like(args[0])
        ws_bytes = 0 if same_interface else old_lib.comorag_encoder_ffn_workspace_bytes(n, h, inter, sms)
        workspace = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=device)

        def old():
            rc = fn(*(a.data_ptr() for a in args), out.data_ptr(), workspace.data_ptr() if ws_bytes > 0 else None,
                    n, h, inter, 1e-12, sms, torch.cuda.current_stream(device).cuda_stream)
            build.check(old_lib, rc, "earlier encoder_ffn")
            return out

        def new():
            return ffn.encoder_ffn(*args)

        if same_interface:
            old = through_wrapper("encoder_ffn", old_lib, new)
        plain = ffn.encoder_ffn_plain(*args)
        ear = old().clone()
        build._libs["encoder_ffn"] = new_lib
        cur = new()
        rows.append({"kernel": "encoder_ffn", "shape": [n, h], "inter": inter, **ffn_bound(n, h, inter),
                     **in_turns(old, through_wrapper("encoder_ffn", new_lib, new)),
                     "earlier_rule_ratio": rule_ratio(ear, plain), "current_rule_ratio": rule_ratio(cur, plain)})
    build._libs["encoder_ffn"] = new_lib
    return rows


# comorag_int4_fused_layer_tail's arguments with one packed and one scale
# pointer a weight (the interface up to 7e8341d, since comorag_int4_tail_tile_n;
# later builds take arrays of column blocks: comorag_int4_tail_max_blocks)
PER_WEIGHT_TAIL_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


# comorag_int4_matmul_splitk's and _wgmma's arguments with one packed and
# one scale pointer (the interface up to eecb372; later builds take arrays
# of column blocks: comorag_int4_matmul_max_blocks)
PER_WEIGHT_MATMUL_ARGTYPES = {
    "comorag_int4_matmul_splitk": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "comorag_int4_matmul_wgmma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def type_int4_entries(lib: ctypes.CDLL) -> None:
    """Types the entries of ops.int4's C interface that an earlier build
    of csrc/int4.cu has (it may lack the newer ones; a fused tail, split-K
    or wgmma entry of the per-weight interface gets its own argument
    types)."""
    tail_blocks = hasattr(lib, "comorag_int4_tail_max_blocks")
    matmul_blocks = hasattr(lib, "comorag_int4_matmul_max_blocks")
    for name, restype, argtypes in int4._C_ENTRIES:
        if hasattr(lib, name):
            if name == "comorag_int4_fused_layer_tail" and not tail_blocks:
                argtypes = PER_WEIGHT_TAIL_ARGTYPES
            if name in PER_WEIGHT_MATMUL_ARGTYPES and not matmul_blocks:
                argtypes = PER_WEIGHT_MATMUL_ARGTYPES[name]
            getattr(lib, name).restype, getattr(lib, name).argtypes = restype, argtypes


def matmul_call(lib: ctypes.CDLL, route: str, x, packed, scales, out, workspace, tickets, splits: int,
                sms: int, stream: int) -> None:
    """One launch of csrc/int4.cu's C entry for ``route``, on buffers made
    by the caller (the whole weight: one block where the entry takes
    blocks)."""
    (m, k), n = x.shape, packed.shape[1]
    weight = (packed.data_ptr(), scales.data_ptr())
    if route != "mma_sync" and hasattr(lib, "comorag_int4_matmul_max_blocks"):
        one = ctypes.c_void_p * 1
        weight = (one(packed.data_ptr()), one(scales.data_ptr()), 1)
    if route == "splitk":
        rc = lib.comorag_int4_matmul_splitk(x.data_ptr(), *weight, out.data_ptr(), workspace.data_ptr(),
                                            tickets.data_ptr(), m, n, k, 128, splits, sms, stream)
    elif route == "wgmma":
        rc = lib.comorag_int4_matmul_wgmma(x.data_ptr(), *weight, out.data_ptr(), m, n, k, 128, sms, stream)
    else:
        rc = lib.comorag_int4_matmul(x.data_ptr(), *weight, out.data_ptr(), m, n, k, 128, stream)
    build.check(lib, rc, f"int4_matmul ({route})")


def matmul_ab(old_lib: ctypes.CDLL, device) -> list:
    """int4_matmul at phase 9's shapes, cycling through 8 layers' weights
    (past the 50 MB L2; one for lm_head). Both libraries' C entries are
    called directly, their buffers made outside the timed loop, so the
    times are the kernels' without the wrapper's host work (chip_smoke's
    host_us): the current library at the wrapper's route and plan, the
    earlier one at the same route where it has that entry, else at its
    ``comorag_int4_matmul`` (fdbff70 and before: one mma.sync kernel for
    every shape)."""
    new_lib = int4._lib()
    type_int4_entries(old_lib)
    arch = llama_8b()
    sms = int4._sm_count(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(9)
    rows = []
    for m, name in INT4_MATMUL_SHAPES:
        k, n = int4_matmul_dims(arch, name)
        layers = 1 if name == "lm_head" else 8
        packed = torch.randint(-128, 128, (layers, k // 2, n), generator=gen, device=device, dtype=torch.int8)
        scales = torch.empty(layers, k // 128, n, device=device).uniform_(0.003, 0.006, generator=gen)
        x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
        route = int4.int4_matmul_route(m, n)
        old_route = route if hasattr(old_lib, f"comorag_int4_matmul_{route}") else "mma_sync"
        splits = (int4.matmul_plan(m, k, n, 128, sms, *int4._splitk_geometry(device, m))["splits"]
                  if route == "splitk" else 1)
        # the earlier split-K build reads a workspace even at one split
        workspace = torch.empty(splits * m * n, device=device)
        tickets = {lib: torch.zeros(n // 128, dtype=torch.int32, device=device) for lib in (old_lib, new_lib)}
        outs = {lib: torch.empty(m, n, device=device) for lib in (old_lib, new_lib)}
        state = {"i": 0}

        def run(lib, r):
            def call():
                i = state["i"] = (state["i"] + 1) % layers
                matmul_call(lib, r, x, packed[i], scales[i], outs[lib], workspace, tickets[lib], splits, sms, stream)
            return call

        old, new = run(old_lib, old_route), run(new_lib, route)
        plain = int4.int4_matmul_plain(x, packed[0], scales[0])
        ratios = {}
        for tag, lib, call in (("earlier", old_lib, old), ("current", new_lib, new)):
            state["i"] = -1  # layer 0, as plain
            call()
            ratios[f"{tag}_rule_ratio"] = rule_ratio(outs[lib], plain)
        rows.append({"kernel": "int4_matmul", "M": m, "weight": name, "K": k, "N": n, "route": route,
                     "earlier_route": old_route, "splits": splits, **int4_bound(m, k, n), **in_turns(old, new),
                     **device_in_turns(old, new), **(host_in_turns(old, new) if m <= int4.TAIL_MAX_M else {}),
                     **ratios})
        del packed, scales, x, plain, workspace, tickets, outs
        torch.cuda.empty_cache()
    return rows


def tail_ab(old_lib: ctypes.CDLL, device) -> list:
    """The fused tail at phase 9's M = 8 and 64 over whole weights, cycling
    through 32 layers: through the wrapper with the earlier library swapped
    in where it has the current interface, else its C entry called directly
    (the per-weight interface of 7e8341d and before, at the current plan;
    a8e4f4b's first design)."""
    new_lib = int4._lib()
    type_int4_entries(old_lib)
    same_interface = hasattr(old_lib, "comorag_int4_tail_max_blocks")
    per_weight = not same_interface and hasattr(old_lib, "comorag_int4_tail_tile_n")
    fn = old_lib.comorag_int4_fused_layer_tail
    if not same_interface and not per_weight:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    arch = llama_8b()
    h, inter, layers = arch.hidden_size, arch.intermediate_size, arch.num_layers
    gen = torch.Generator(device=device).manual_seed(9)

    def weights(k, n):
        packed = torch.randint(-128, 128, (layers, k // 2, n), generator=gen, device=device, dtype=torch.int8)
        return packed, torch.empty(layers, k // 128, n, device=device).uniform_(0.003, 0.006, generator=gen)

    w = [weights(h, h), weights(h, 2 * inter), weights(inter, h)]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for m in (8, 64):
        ctx = torch.randn(m, h, generator=gen, device=device).to(torch.bfloat16)
        xres = torch.randn(m, h, generator=gen, device=device)
        nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device=device)
        out, xmid = torch.empty(m, h, device=device), torch.empty(m, h, device=device)
        xn, hb = torch.empty(m, h, device=device, dtype=torch.bfloat16), torch.empty(m, inter, device=device, dtype=torch.bfloat16)
        state = {"i": 0}

        def layer_args():
            i = state["i"] = (state["i"] + 1) % layers
            return [t for pair in w for t in (pair[0][i], pair[1][i])]

        if per_weight:
            splits = int4._tail_splits(m, h, inter, 128, sms, *int4._tail_geometry(device, m))
            workspace = torch.empty(old_lib.comorag_int4_tail_workspace_bytes(m, h, inter, *splits),
                                    dtype=torch.uint8, device=device)
            tickets = torch.zeros((2 * h + inter) // 128, dtype=torch.int32, device=device)

        def old():
            a = layer_args()
            stream = torch.cuda.current_stream(device).cuda_stream
            if per_weight:
                rc = fn(ctx.data_ptr(), xres.data_ptr(), nw.data_ptr(), *(t.data_ptr() for t in a), out.data_ptr(),
                        workspace.data_ptr(), tickets.data_ptr(), m, h, inter, 128, *splits, 1e-5, 0, 0, sms, stream)
            else:
                rc = fn(ctx.data_ptr(), xres.data_ptr(), nw.data_ptr(), *(t.data_ptr() for t in a), out.data_ptr(),
                        xmid.data_ptr(), xn.data_ptr(), hb.data_ptr(), m, h, inter, 128, 1e-5, 0, 0, sms, stream)
            build.check(old_lib, rc, "earlier int4_fused_layer_tail")

        def new():
            return int4.int4_fused_layer_tail(ctx, xres, nw, *layer_args(), eps=1e-5)

        def new_direct():  # the current C entry with each weight as one block, no wrapper
            a = [(ctypes.c_void_p * 1)(t.data_ptr()) for t in layer_args()]
            rc = new_lib.comorag_int4_fused_layer_tail(
                ctx.data_ptr(), xres.data_ptr(), nw.data_ptr(), a[0], a[1], 1, a[2], a[3], 1, a[4], a[5], 1,
                out_new.data_ptr(), workspace.data_ptr(), tickets_new.data_ptr(), m, h, inter, 128, *splits, 1e-5,
                0, 0, sms, torch.cuda.current_stream(device).cuda_stream)
            build.check(new_lib, rc, "int4_fused_layer_tail")

        if same_interface:
            old = through_wrapper("int4", old_lib, new)
            timed = {**in_turns(old, through_wrapper("int4", new_lib, new)),
                     **device_in_turns(old, through_wrapper("int4", new_lib, new)),
                     **host_in_turns(old, through_wrapper("int4", new_lib, new))}
        elif per_weight:  # both C entries called directly: the kernels' times without the wrapper's host work
            out_new, tickets_new = torch.empty_like(out), torch.zeros_like(tickets)
            timed = {**in_turns(old, new_direct), **device_in_turns(old, new_direct),
                     "earlier_direct_host_us": host_us(old), "current_direct_host_us": host_us(new_direct),
                     "current_wrapper_ms": median_ms(through_wrapper("int4", new_lib, new)),
                     "current_wrapper_host_us": host_us(through_wrapper("int4", new_lib, new))}
        else:
            timed = in_turns(old, through_wrapper("int4", new_lib, new))
        rows.append({"kernel": "int4_fused_layer_tail", "M": m, "H": h, "I": inter, **tail_bound(m, h, inter),
                     **timed})
        # the outputs of both, beside the plain version, under the bf16 rule
        a = layer_args()
        plain = int4.int4_fused_layer_tail_plain(ctx, xres, nw, *a, eps=1e-5)
        build._libs["int4"] = new_lib
        cur = int4.int4_fused_layer_tail(ctx, xres, nw, *a, eps=1e-5)
        if same_interface:
            build._libs["int4"] = old_lib
            ear = int4.int4_fused_layer_tail(ctx, xres, nw, *a, eps=1e-5)
        else:
            state["i"] -= 1
            old()
            ear = out
        rows[-1].update({"earlier_rule_ratio": rule_ratio(ear, plain), "current_rule_ratio": rule_ratio(cur, plain)})
    build._libs["int4"] = new_lib
    return rows


# dbd2d73's scan routes and their C codes: fp32 rows of 32 queries or more
# with k <= 64 (d % 4 == 0, aligned) on the FFMA "wide" scan, other fp32
# calls on "scan", int8 rows with k <= 64 and d % 16 == 0 on "mma"
EARLIER_ROUTES = {"scan": 0, "wide": 1, "mma": 2}


def earlier_route(p: int, rows: torch.Tensor) -> str:
    if rows.dtype == torch.int8:
        return "mma"
    return "wide" if p >= 32 and BENCH_K <= 64 and rows.shape[1] % 4 == 0 else "scan"


def topk_ab(old_lib: ctypes.CDLL, device) -> list:
    """mips_topk (fp32 rows) and mips_topk_int8 on phase 6's corpus
    (100,000 x 1024, k = 50) at P = 16, 32 and 256, both libraries' C
    entries called directly on buffers made outside the timed loop: the
    current one at ``ops.mips.scan_route``'s route, the earlier one
    (dbd2d73's interface) at its own route table. Each result is held
    against the plain score matrix (ops/mips.check_topk)."""
    new_lib = mips._lib()
    for fn in (old_lib.comorag_mips_topk, old_lib.comorag_mips_topk_int8):
        fn.restype = ctypes.c_int
    old_lib.comorag_mips_topk.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    old_lib.comorag_mips_topk_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    ws = old_lib.comorag_mips_topk_workspace_bytes
    ws.restype = ctypes.c_longlong
    ws.argtypes = [ctypes.c_int] * 5
    sms = mips._sm_count(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    corpus, queries = bench_data(256)
    c32 = torch.tensor(corpus, device=device)
    cq, sc = (torch.tensor(a, device=device) for a in quantize_int8(corpus))
    del corpus
    n, d = c32.shape
    rows = []
    for p in (16, 32, 256):
        q = torch.tensor(queries[:p], device=device)
        for kernel, entry, head, scores in (
                ("mips_topk", "comorag_mips_topk", (q.data_ptr(), c32.data_ptr(), 0), lambda: dense_scores(q, c32)),
                ("mips_topk_int8", "comorag_mips_topk_int8", (q.data_ptr(), cq.data_ptr(), sc.data_ptr()),
                 lambda: int8_scores(q, cq, sc))):
            row_t = c32 if kernel == "mips_topk" else cq
            routes = {old_lib: earlier_route(p, row_t), new_lib: route_of(q, row_t, BENCH_K)}
            codes = {old_lib: EARLIER_ROUTES[routes[old_lib]], new_lib: mips.SCAN_ROUTES.index(routes[new_lib])}
            outs = {lib: (torch.empty(p, BENCH_K, device=device),
                          torch.empty(p, BENCH_K, dtype=torch.int64, device=device)) for lib in routes}
            wss = {lib: torch.empty(lib.comorag_mips_topk_workspace_bytes(p, n, d, BENCH_K, sms), dtype=torch.uint8,
                                    device=device) for lib in routes}

            def call(lib, entry=entry, head=head, codes=codes, outs=outs, wss=wss, p=p):
                rc = getattr(lib, entry)(*head, p, n, d, BENCH_K, codes[lib], sms, wss[lib].data_ptr(),
                                         outs[lib][0].data_ptr(), outs[lib][1].data_ptr(), stream)
                build.check(lib, rc, entry)

            plain = scores()
            errs = {}
            for tag, lib in (("earlier", old_lib), ("current", new_lib)):
                call(lib)
                torch.cuda.synchronize()
                errs[f"{tag}_max_abs_err"] = mips.check_topk(*outs[lib], plain, f"{tag} {kernel} P={p}")
            del plain
            rows.append({"kernel": kernel, "P": p, "N": n, "d": d, "k": BENCH_K, "earlier_route": routes[old_lib],
                         "route": routes[new_lib],
                         **in_turns(lambda: call(old_lib), lambda: call(new_lib)), **errs})
    return rows


# kernel -> (its csrc source, its A/B)
RUNS = {"attention": ("encoder_attention", attention_ab), "ffn": ("encoder_ffn", ffn_ab),
        "matmul": ("int4", matmul_ab), "tail": ("int4", tail_ab), "topk": ("mips_topk", topk_ab)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old-csrc", required=True, help="directory holding the earlier csrc/*.cu and *.cuh")
    p.add_argument("--kernels", nargs="+", choices=sorted(RUNS), default=sorted(RUNS),
                   help="which kernels to time (default: all)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA card")
    device = torch.device("cuda", 0)
    sources = sorted({RUNS[k][0] for k in args.kernels})
    build.load_all(sources)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        old_libs = dict(zip(sources, pool.map(lambda name: build_old(args.old_csrc, name), sources)))
    for k in args.kernels:
        for row in RUNS[k][1](old_libs[RUNS[k][0]], device):
            print(json.dumps(row), flush=True)
    print(nvidia_smi_line())


if __name__ == "__main__":
    main()
