"""A/B timing of comorag_torch's encoder FFN, encoder attention and int4
fused layer tail against an earlier version of the same CUDA sources, in
one process on one card.

    git archive <commit> comorag_torch/csrc | tar -x -C build/ab_old
    python scripts/torch_kernel_ab.py --old-csrc build/ab_old/comorag_torch/csrc [--kernels ffn attention tail]

The earlier sources are built with the same nvcc flags into the build
directory. Each kernel runs through the same wrapper for both (the library
is swapped under ``ops.ffn``, ``ops.attention`` and ``ops.int4``), except
where the earlier source has another C interface, which is then called
directly, with its workspaces made once outside the timed loop: a fused
tail with the first design's (commit a8e4f4b: no
``comorag_int4_tail_tile_n``) and an FFN with the fused mma.sync design's
(up to commit 864f5f5: no ``comorag_encoder_ffn_tile``). Times are
medians of CUDA-event samples (chip_smoke's ``median_ms``), taken in
turns: earlier, current, current, earlier. Prints one JSON line per shape
and the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (ffn_bound, ffn_inputs, llama_8b, median_ms, nvidia_smi_line, ragged_mask,  # noqa: E402
                        rule_ratio, tail_bound)
from comorag_torch.ops import attention, build, ffn, int4  # noqa: E402


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


def tail_ab(old_lib: ctypes.CDLL, device) -> list:
    new_lib = int4._lib()
    same_interface = hasattr(old_lib, "comorag_int4_tail_tile_n")
    fn = old_lib.comorag_int4_fused_layer_tail
    if not same_interface:
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

        def old():
            a = layer_args()
            rc = fn(ctx.data_ptr(), xres.data_ptr(), nw.data_ptr(), *(t.data_ptr() for t in a), out.data_ptr(),
                    xmid.data_ptr(), xn.data_ptr(), hb.data_ptr(), m, h, inter, 128, 1e-5, 0, 0, sms,
                    torch.cuda.current_stream(device).cuda_stream)
            build.check(old_lib, rc, "earlier int4_fused_layer_tail")

        def new():
            return int4.int4_fused_layer_tail(ctx, xres, nw, *layer_args(), eps=1e-5)

        if same_interface:
            old = through_wrapper("int4", old_lib, new)
        rows.append({"kernel": "int4_fused_layer_tail", "M": m, "H": h, "I": inter, **tail_bound(m, h, inter),
                     **in_turns(old, through_wrapper("int4", new_lib, new))})
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


# kernel -> (its csrc source, its A/B)
RUNS = {"attention": ("encoder_attention", attention_ab), "ffn": ("encoder_ffn", ffn_ab),
        "tail": ("int4", tail_ab)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old-csrc", required=True, help="directory holding the earlier csrc/*.cu and *.cuh")
    p.add_argument("--kernels", nargs="+", choices=sorted(RUNS), default=sorted(RUNS),
                   help="which kernels to time (default: all)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA card")
    device = torch.device("cuda", 0)
    sources = [RUNS[k][0] for k in args.kernels]
    build.load_all(sources)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        old_libs = list(pool.map(lambda name: build_old(args.old_csrc, name), sources))
    for k, old_lib in zip(args.kernels, old_libs):
        for row in RUNS[k][1](old_lib, device):
            print(json.dumps(row), flush=True)
    print(nvidia_smi_line())


if __name__ == "__main__":
    main()
