"""Offline (in-process) LLM generation on one torch device, or tensor
parallel over a mesh's ``model`` axis.

Port of ``comorag_tpu/llm/jax_offline.py`` (``JaxOfflineLLM`` :113) as
``TorchOfflineLLM``: the same constructor arguments plus ``device``, the
same byte tokenizer and chat framing, prompt/batch/new-token buckets,
shared-prefix LRU, KV token-budget admission (charging the chunked
prefill's score slabs), adaptive speculative fallback, per-row error
isolation in ``batch_infer`` and ``llm.*`` counters. The model is
``models/decoder.py``; ``param_dtype="int4"`` runs every weight product
through the int4 Hopper kernels on a CUDA device.

The device defaults to ``cuda`` and raises without a card unless the
caller passes ``device="cpu"`` (the plain PyTorch path). ``mesh=`` (a
``parallel.mesh.Mesh``) runs the engine on the mesh's first device and,
where the mesh has a ``model`` axis, splits the weights over it after
quantization (``decoder.shard_params``, jax_offline.py:248-256): each
product runs as ``decoder.product_route`` routes it, on the int4 kernels
for an int4 engine.
``params`` may be a tree trained over a mesh (``Sharded`` leaves, from
``models.train_lm``): it is unsharded first (``decoder.unshard_params``)
and split anew over the engine's own mesh, as JAX takes global arrays.

Over a mesh that spans processes (``parallel/distributed.py``) every
process builds the engine on its own merge device from the same weights
and seed. Where the ``model`` axis crosses processes each keeps its own
blocks alone and every product merges across processes
(``across_processes``): every process must then make the same calls in
the same order (``GenerationServer`` serves them one at a time), and each
engine call first agrees on a digest of its token rows and generation
arguments (``distributed.agree``), so that a call that differs in one
process raises in every process instead of pairing other collectives.
Without a model axis there, or where each process holds the whole axis,
each process runs a replica of the engine that meets no other process
(greedy decoding gives every process the same text).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.llm.base import BaseLLM, LLMResponse, Messages
from comorag_torch.llm.guided import JSON_TEMPLATES, compile_json_schema, make_token_table
from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import Sharded, mesh_device, model_part
from comorag_torch.utils import trace
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ByteTokenizer:
    """Hermetic byte-level tokenizer: ids 0..255 are raw bytes, plus
    PAD/BOS/EOS specials. Guided decoding over this vocab degenerates to
    the byte DFA itself — the exact-constraint fast path."""

    pad_token_id = 256
    bos_token_id = 257
    eos_token_id = 258
    vocab_size = 259

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self) -> List[Optional[bytes]]:
        return [bytes([i]) for i in range(256)] + [None, None, None]


def _gpt2_byte_unicode() -> Dict[int, str]:
    """The byte-level-BPE bytes->unicode alphabet (GPT-2 lineage; public
    algorithm): printable latin-1 bytes map to themselves, everything else
    shifts into 0x100+ so every token is printable. Inverting this map is
    the only correct way to recover a byte-level token's bytes."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def render_chat(messages: Messages) -> str:
    """Minimal chat template (the reference delegates to
    ``tokenizer.apply_chat_template``, vllm_offline.py:14-25; a byte-level
    model has no pretrained template, so the framing is explicit)."""
    parts = []
    for m in messages:
        parts.append(f"### {m['role'].capitalize()}:\n{m['content']}\n\n")
    parts.append("### Assistant:\n")
    return "".join(parts)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


_PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
_NEW_TOKEN_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _common_prefix_len(id_rows: Sequence[List[int]]) -> int:
    """Longest common token prefix across rows, capped so every row keeps
    at least one token to prefill (the last-prompt-logits source)."""
    first = id_rows[0]
    min_len = min(len(r) for r in id_rows)
    common = 0
    while common < min_len - 1 and all(r[common] == first[common] for r in id_rows):
        common += 1
    return common


def _holds_sharded(tree) -> bool:
    if isinstance(tree, Sharded):
        return True
    values = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, tuple) else ()
    return any(_holds_sharded(v) for v in values)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class TorchOfflineLLM(BaseLLM):
    """In-process generation engine with the BaseLLM interface."""

    # OpenIE passes json_template="ner"/"triples" when the client can
    # constrain decoding
    supports_guided_json = True

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        params: Optional[Dict[str, Any]] = None,
        arch=None,
        tokenizer=None,
        mesh=None,
        max_model_len: int = 4096,
        max_new_tokens: int = 2048,
        temperature: float = 0.0,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        param_dtype=None,  # None | "int8" | "int4" | a float dtype for storage
        speculative: bool = False,
        draft_len: int = 7,
        kv_dtype=None,  # None (compute dtype) | "int8": quantized KV cache
        kv_budget_bytes: int = 6 << 30,  # per-call KV-cache ceiling (see below)
        spec_fallback_ratio: float = 2.2,  # spec step cost / plain step cost
        device: Union[str, torch.device, None] = None,  # "cuda" when None; the mesh's first device under a mesh
    ):
        from comorag_torch.models import decoder

        self.device = mesh_device(mesh, device)
        self.mesh = mesh
        if model_name_or_path is not None:
            params, arch = decoder.load_hf_decoder_checkpoint(model_name_or_path, device="cpu")
            if tokenizer is None:
                from transformers import AutoTokenizer

                try:
                    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
                except Exception:
                    # checkpoints whose fast-tokenizer conversion fails: the
                    # engine needs only encode/decode and the vocab
                    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, use_fast=False)
        elif params is None or arch is None:
            # hermetic engine: tiny random weights, byte vocab
            arch = arch or decoder.DecoderArch.tiny()
            params = decoder.init_params(arch, torch.Generator().manual_seed(seed), device="cpu")

        self.arch = arch
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_model_len = min(max_model_len, arch.max_seq_len)
        # the new-token budget must leave prompt room inside the model window
        self.max_new_tokens = max(1, min(max_new_tokens, self.max_model_len - _PROMPT_BUCKETS[0]))
        self.temperature = temperature
        self.compute_dtype = compute_dtype
        self.kv_dtype = "int8" if kv_dtype in ("int8", torch.int8) else None
        self._gen = torch.Generator().manual_seed(seed)
        # infer() may be called from many question threads; the generator
        # and the prefix LRU are the engine's only mutable host state
        self._state_lock = threading.Lock()
        self._token_tables: Dict[str, torch.Tensor] = {}
        self._prefix_lru: "OrderedDict[tuple, Any]" = OrderedDict()
        self._prefix_lru_max = 4
        self.prefix_cache_min = 64  # tokens; shorter prefixes aren't worth a phase

        # Token-budget admission: a batch is admitted by KV-cache bytes plus
        # the chunked prefill's fp32 score and probs slabs ([B, 512, heads,
        # total] each), which scale with admitted rows like the cache does.
        hd = arch.head_dim
        if self.kv_dtype == "int8":
            slot_bytes = arch.num_layers * 2 * arch.num_kv_heads * (hd + 4)
        else:
            slot_bytes = arch.num_layers * 2 * arch.num_kv_heads * hd * _itemsize(compute_dtype)
        slot_bytes += arch.num_heads * decoder._PREFILL_CHUNK * 4 * 2
        self._slot_row_budget = max(1, int(kv_budget_bytes) // slot_bytes)

        if _holds_sharded(params):
            params = decoder.unshard_params(params, self.device)
        params = decoder.params_from_jax(params, self.device)
        if param_dtype == "int4":
            params = decoder.quantize_params_int4(params)
        elif param_dtype in ("int8", torch.int8):
            params = decoder.quantize_params(params)
        elif param_dtype is not None:
            params = decoder.map_weights(
                params, lambda p: p.to(param_dtype) if torch.is_floating_point(p) else p)
        if mesh is not None and "model" in mesh.shape:
            params = decoder.shard_params(params, mesh)
        self.params = params
        # products merge across processes: every engine call is a sequence
        # of collectives that all processes enter in the same order
        self.across_processes = mesh is not None and model_part(mesh)[0] is not None

        self.speculative = bool(speculative)
        self.draft_len = int(draft_len)
        # Adaptive fallback: a spec step verifies draft_len+1 positions and
        # costs a multiple (spec_fallback_ratio) of a plain 1-token step, so
        # spec only pays when it commits more tokens per step than that. An
        # EMA of committed tokens per step drops permanently to the plain
        # loop once the evidence says spec loses.
        self._spec_active = self.speculative
        self._spec_ratio = float(spec_fallback_ratio)
        self._spec_eff_ema: Optional[float] = None
        self._spec_calls = 0

    # ----------------------------------------------------------- tokenizer
    def _render(self, messages: Messages) -> Tuple[str, bool]:
        """The checkpoint's own chat template when the tokenizer carries
        one, else the generic framing. Returns ``(text, add_special_tokens)``."""
        tok = self.tokenizer
        if getattr(tok, "chat_template", None):
            try:
                text = tok.apply_chat_template(list(messages), tokenize=False, add_generation_prompt=True)
                return text, False
            except Exception as exc:  # malformed/unrenderable template
                if not getattr(self, "_warned_template", False):
                    self._warned_template = True
                    logger.warning("chat template failed (%s); using generic framing", exc)
        return render_chat(messages), True

    def _ids(self, text: str, add_special: bool = True) -> List[int]:
        tok = self.tokenizer
        if isinstance(tok, ByteTokenizer):
            return [tok.bos_token_id] + tok.encode(text)
        return tok(text, add_special_tokens=add_special)["input_ids"]

    def _special_ids(self):
        tok = self.tokenizer
        pad = getattr(tok, "pad_token_id", None)
        eos = getattr(tok, "eos_token_id", None)
        if pad is None:
            pad = eos
        return int(pad), int(eos)

    def _decode_ids(self, ids: Sequence[int]) -> str:
        tok = self.tokenizer
        if isinstance(tok, ByteTokenizer):
            return tok.decode(ids)
        return tok.decode(ids, skip_special_tokens=True)

    def _hf_token_bytes(self) -> List[Optional[bytes]]:
        """Byte expansion of an HF vocab sized to the model's logits width:
        byte-level BPE through the bytes<->unicode alphabet, sentencepiece
        through its space marker and ``<0xNN>`` byte tokens; unknown and
        special ids stay None (forbidden)."""
        import re

        tok = self.tokenizer
        out: List[Optional[bytes]] = [None] * self.arch.vocab_size
        special = set(getattr(tok, "all_special_ids", []) or [])
        n = min(len(tok), self.arch.vocab_size)
        toks = tok.convert_ids_to_tokens(list(range(n)))
        byte_re = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
        u2b: Dict[str, int] = getattr(tok, "byte_decoder", None) or {
            u: b for b, u in _gpt2_byte_unicode().items()
        }
        is_byte_level = getattr(tok, "byte_decoder", None) is not None or any(
            t is not None and ("Ġ" in t or "Ċ" in t) for t in toks
        )
        for i, t in enumerate(toks):
            if t is None or i in special:
                continue
            m = byte_re.match(t)
            if m:
                out[i] = bytes([int(m.group(1), 16)])
                continue
            if is_byte_level:
                try:
                    out[i] = bytes(u2b[ch] for ch in t)
                except KeyError:
                    out[i] = None  # outside the byte alphabet -> forbidden
            else:
                out[i] = t.replace("▁", " ").encode("utf-8")
        return out

    def _token_table(self, template: str) -> torch.Tensor:
        if template not in JSON_TEMPLATES:
            raise KeyError(f"unknown json_template {template!r}; have {sorted(JSON_TEMPLATES)}")
        with self._state_lock:
            if template not in self._token_tables:
                dfa = compile_json_schema(JSON_TEMPLATES[template])
                tok = self.tokenizer
                token_bytes = tok.token_bytes() if isinstance(tok, ByteTokenizer) else self._hf_token_bytes()
                _, eos = self._special_ids()
                if eos >= len(token_bytes):
                    raise ValueError(f"eos_token_id {eos} outside the model vocab {len(token_bytes)} "
                                     "— constrained decoding could never stop")
                table = make_token_table(dfa, token_bytes, eos_token_id=eos)
                self._token_tables[template] = torch.as_tensor(np.asarray(table), device=self.device)
            return self._token_tables[template]

    # ------------------------------------------------------------ generate
    def _shared_prefix(self, id_rows: List[List[int]]):
        """A shared prompt header worth caching: the longest common token
        prefix, floored to 64 tokens. Batch-of-one calls only reuse a cached
        header; multi-row batches build and cache one. Returns (prefix cache
        | None, prefix_len). Called under the state lock."""
        from comorag_torch.models.decoder import prefill_prefix

        first = id_rows[0]
        common = _common_prefix_len(id_rows)
        # every row keeps at least one token after the strip
        common = max(0, min(common, min(len(r) for r in id_rows) - 1))
        p0 = (common // 64) * 64
        best_key, best_len = None, 0
        for key in self._prefix_lru:
            k0 = len(key)
            if self.prefix_cache_min <= k0 <= common and k0 > best_len and key == tuple(first[:k0]):
                best_key, best_len = key, k0
        if best_key is not None and (len(id_rows) == 1 or best_len >= p0):
            self._prefix_lru.move_to_end(best_key)
            return self._prefix_lru[best_key], best_len
        if len(id_rows) == 1 or p0 < self.prefix_cache_min:
            return None, 0
        key = tuple(first[:p0])
        with torch.no_grad():
            cache = prefill_prefix(self.params, list(key), self.arch, self.compute_dtype, kv_dtype=self.kv_dtype)
        self._prefix_lru[key] = cache
        if len(self._prefix_lru) > self._prefix_lru_max:
            self._prefix_lru.popitem(last=False)
        return cache, p0

    def _next_generator(self) -> torch.Generator:
        """A generator for one call on the engine's device, seeded from the
        engine's own (the counterpart of JAX's key split)."""
        with self._state_lock:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _generate_batch(
        self,
        prompts: List[str],
        max_tokens: int,
        json_template: Optional[str],
        temperature: Optional[float],
        id_rows: Optional[List[List[int]]] = None,
    ) -> List[LLMResponse]:
        from comorag_torch.models.decoder import generate, generate_speculative

        pad, eos = self._special_ids()
        temp = self.temperature if temperature is None else float(temperature)
        fit = [b for b in _NEW_TOKEN_BUCKETS if b <= self.max_model_len - _PROMPT_BUCKETS[0]]
        max_new = _bucket(min(max_tokens, self.max_new_tokens), fit or _NEW_TOKEN_BUCKETS[:1])
        requested = min(max_tokens, self.max_new_tokens, max_new)

        if id_rows is None:
            id_rows = [self._ids(p) for p in prompts]
        limit = max(self.max_model_len - max_new, _PROMPT_BUCKETS[0])
        id_rows = [r[-limit:] if len(r) > limit else r for r in id_rows]

        with self._state_lock:
            prefix_cache, p0 = self._shared_prefix(id_rows)
        if p0:
            id_rows = [r[p0:] for r in id_rows]
            limit -= p0
        p_len = _bucket(max(max(len(r) for r in id_rows), 1), _PROMPT_BUCKETS)
        p_len = min(p_len, limit)
        b = _bucket(len(id_rows), _BATCH_BUCKETS)

        ids = np.full((b, p_len), pad, np.int64)
        mask = np.zeros((b, p_len), np.int64)
        for i, row in enumerate(id_rows):
            row = row[-p_len:]
            ids[i, p_len - len(row):] = row  # LEFT padding (decoder contract)
            mask[i, p_len - len(row):] = 1
        mask[len(id_rows):, -1] = 1  # batch-pad rows: one valid slot
        row_valid = np.zeros((b,), bool)
        row_valid[: len(id_rows)] = True

        table = self._token_table(json_template) if json_template else None
        common = dict(
            row_valid=torch.as_tensor(row_valid, device=self.device),
            arch=self.arch,
            max_new_tokens=max_new,
            eos_id=eos,
            pad_id=pad,
            token_table=table,
            limit=requested,
            prefix=prefix_cache,
            compute_dtype=self.compute_dtype,
            kv_dtype=self.kv_dtype,
        )
        used_spec = self.speculative and self._spec_active
        gen = self._next_generator()
        ids_t = torch.as_tensor(ids, device=self.device)
        mask_t = torch.as_tensor(mask, device=self.device)
        with torch.no_grad():
            if used_spec:
                result = generate_speculative(self.params, ids_t, mask_t, draft_len=self.draft_len,
                                              temperature=temp, rng=gen, **common)
            else:
                result = generate(self.params, ids_t, mask_t, temperature=temp, rng=gen, **common)
        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        steps = int(result.steps)

        trace.count("llm.calls")
        trace.count("llm.rows", len(id_rows))
        trace.count("llm.prompt_tokens", sum(p0 + len(r) for r in id_rows))
        trace.count("llm.cached_prefix_tokens", p0 * len(id_rows))
        trace.count("llm.completion_tokens", int(lengths[: len(id_rows)].sum()))
        trace.count("llm.decode_steps", steps)
        if used_spec:
            # a plain loop would have needed max(lengths) 1-token steps
            eff = max(int(lengths[: len(id_rows)].max()), 1) / max(steps, 1)
            with self._state_lock:
                self._spec_calls += 1
                ema = self._spec_eff_ema
                self._spec_eff_ema = eff if ema is None else 0.7 * ema + 0.3 * eff
                trace.gauge("llm.spec_tokens_per_step", self._spec_eff_ema)
                if self._spec_calls >= 3 and self._spec_eff_ema < self._spec_ratio:
                    self._spec_active = False
                    trace.count("llm.spec_fallback")
                    logger.info("speculative decode committing %.2f tok/step (< %.1fx step-cost ratio) — "
                                "falling back to the plain decode loop", self._spec_eff_ema, self._spec_ratio)

        out = []
        for i, row in enumerate(id_rows):
            n = int(lengths[i])
            raw = tokens[i, :n].tolist()
            stopped = eos in raw or n < requested
            text = self._decode_ids([t for t in raw if t != eos])
            out.append(LLMResponse(text=text, metadata={
                "prompt_tokens": p0 + len(row),
                "cached_prefix_tokens": p0,
                "completion_tokens": n,
                "finish_reason": "stop" if stopped else "length",
                "decode_steps": steps,
            }))
        return out

    # ---------------------------------------------------------- interface
    def _max_tokens(self, gen_kwargs: Dict) -> int:
        """max_tokens, or its OpenAI-client spelling max_completion_tokens."""
        mt = gen_kwargs.get("max_tokens")
        if mt is None:
            mt = gen_kwargs.get("max_completion_tokens")
        return int(self.max_new_tokens if mt is None else mt)

    def infer(self, messages: Messages, **gen_kwargs) -> LLMResponse:
        text, sp = self._render(messages)
        id_rows = [self._ids(text, sp)]
        max_tokens, template, temperature = (self._max_tokens(gen_kwargs), gen_kwargs.get("json_template"),
                                             gen_kwargs.get("temperature"))
        if self.across_processes:  # before the first merge, as batch_infer
            distributed.agree((id_rows, max_tokens, template, temperature),
                              "a call over a model axis across processes")
        return self._generate_batch([text], max_tokens, template, temperature, id_rows=id_rows)[0]

    def batch_infer(self, batch: Sequence[Messages], **gen_kwargs) -> List[LLMResponse]:
        """Real batched decoding, one device call per prompt-length group
        (one group when the batch shares a cacheable header), each group
        split by the KV token budget. A row that fails to render or
        tokenize, and a device call that raises, answer with
        ``finish_reason: "error"`` for their own rows only, except across
        processes (``across_processes``), where the device call's error
        propagates: it may be a disagreement that every process raised,
        and the processes must not go on apart."""
        if not batch:
            return []
        rendered: List[Optional[Tuple[str, object]]] = []
        render_errs: Dict[int, str] = {}
        for i, m in enumerate(batch):
            try:
                rendered.append(self._render(m))
            except Exception as e:  # noqa: BLE001 — per-item isolation
                rendered.append(None)
                render_errs[i] = str(e)
        prompts = [t for t, _ in (r or ("", None) for r in rendered)]
        max_tokens = self._max_tokens(gen_kwargs)
        template = gen_kwargs.get("json_template")
        temperature = gen_kwargs.get("temperature")

        id_rows: List[Optional[List[int]]] = []
        for i, r in enumerate(rendered):
            if r is None:
                id_rows.append(None)
                continue
            try:
                id_rows.append(self._ids(r[0], r[1]))
            except Exception as e:  # noqa: BLE001 — per-item isolation
                id_rows.append(None)
                render_errs[i] = str(e)
        if self.across_processes:  # the groups and chunks below must be every process's
            distributed.agree((id_rows, max_tokens, template, temperature),
                              "a batch over a model axis across processes")
        ok = [i for i in range(len(prompts)) if id_rows[i] is not None]
        common = _common_prefix_len([id_rows[i] for i in ok]) if ok else 0
        groups: Dict[int, List[int]] = {}
        if ok and (common // 64) * 64 >= self.prefix_cache_min:
            groups[0] = ok
        else:
            for i in ok:
                groups.setdefault(_bucket(len(id_rows[i]), _PROMPT_BUCKETS), []).append(i)

        results: List[Optional[LLMResponse]] = [None] * len(prompts)
        for i, msg in render_errs.items():
            logger.warning("offline render/tokenize failed for one row: %s", msg)
            results[i] = LLMResponse(text="", metadata={"error": msg, "finish_reason": "error"})
        fit = [bk for bk in _NEW_TOKEN_BUCKETS if bk <= self.max_model_len - _PROMPT_BUCKETS[0]]
        max_new_est = _bucket(min(max_tokens, self.max_new_tokens), fit or _NEW_TOKEN_BUCKETS[:1])
        limit_est = max(self.max_model_len - max_new_est, _PROMPT_BUCKETS[0])
        for _, idxs in sorted(groups.items()):
            longest = min(max(len(id_rows[i]) for i in idxs), limit_est)
            total_est = min(_bucket(longest, _PROMPT_BUCKETS), limit_est) + max_new_est
            rows_cap = max(1, self._slot_row_budget // total_est)
            max_b = 1
            for bb in _BATCH_BUCKETS:
                if bb <= rows_cap:
                    max_b = bb
            max_b = min(_BATCH_BUCKETS[-1], max_b)
            for j in range(0, len(idxs), max_b):
                chunk = idxs[j : j + max_b]
                try:
                    rs = self._generate_batch([prompts[i] for i in chunk], max_tokens, template, temperature,
                                              id_rows=[id_rows[i] for i in chunk])
                except Exception as e:  # noqa: BLE001 — per-chunk isolation
                    if self.across_processes:
                        raise
                    logger.warning("offline generation chunk failed: %s", e)
                    rs = [LLMResponse(text="", metadata={"error": str(e), "finish_reason": "error"})
                          for _ in chunk]
                for i, r in zip(chunk, rs):
                    results[i] = r
        return results  # type: ignore[return-value]
