"""ServingEngine: continuous-batching GPT serving over the paged cache
(counterpart of paddle_tpu/serving/engine.py, its baseline
configuration).

Ties the pieces together: a weight snapshot (bf16 by default; the f32
parity mode, dtype=None, is held token for token against
models/generation.py greedy), the page pools + host block tables
(paged_cache), the FIFO continuous-batching scheduler, and the engine's
programs (programs.py): one bucketed prefill per prefill bucket and one
decode chunk per decode bucket. On the card each is captured once as a
CUDA graph at warmup() and replayed by every step. One ``step()`` is
one token boundary:

  retire finished -> admit queued (one bucketed prefill for the whole
  mixed-length admit batch) -> one decode dispatch of decode_chunk
  tokens for every active slot -> sentinel check (program count must
  stay == the ladder size)

The engine is single-threaded and host-driven: continuous batching
needs a host decision point at every boundary (who retires, who
admits), so each dispatch is one graph replay and the host reads its
tokens back.

The engine follows the model's device: a model built on the card serves
from the card, one built with device="cpu" from the CPU.

Not ported yet, rejected with NotImplementedError naming the ROADMAP
item: int8 weights (quant), speculative decoding (speculative_k) and
prefix sharing (item 11), tensor-parallel plans (item 14). The JAX engine's metrics, request traces and OOM forensics belong
to the observability slice (item 16).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.generation import _cast_params, _gpt_params, _gumbel
from ..observability.sentinel import RecompileSentinel
from .paged_cache import PagedKVCache
from .programs import ProgramCache, make_decode_fn, make_prefill_fn
from .scheduler import BucketLadder, FifoScheduler, Request

__all__ = ["ServingConfig", "ServingEngine", "build_serving_snapshot"]

_ITEM11 = "ROADMAP.md queue A item 11 (int8, speculative decoding, " \
    "prefix sharing)"


def _leaves(params, path=""):
    """[(path, tensor)] of a generation/serving params dict, in order."""
    if isinstance(params, dict):
        return [x for k in params for x in _leaves(params[k],
                                                   f"{path}/{k}")]
    if isinstance(params, (list, tuple)):
        return [x for i, v in enumerate(params)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, params)]


def build_serving_snapshot(params, cfg) -> dict:
    """Raw generation params -> this config's serving snapshot: the
    float cast to cfg.dtype, as fresh tensors that the engine owns (a
    weight swap copies into them in place; the model's own parameters
    are never written). The one builder that engine build and
    ``swap_weights(cast=True)`` share."""
    dtype = None if cfg.dtype is None else getattr(torch, cfg.dtype)
    return _clone(_cast_params(params, dtype))


def _clone(params):
    if isinstance(params, dict):
        return {k: _clone(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_clone(v) for v in params)
    return params.detach().clone()


@dataclass
class ServingConfig:
    """The serving shape contract. Every field here is static: it fixes
    the program ladder, and nothing a request carries can force a new
    program."""
    max_slots: int = 8                 # concurrent decode lanes
    max_admit: int = 4                 # prefill batch width (padded)
    block_size: int = 16               # tokens per KV page
    n_blocks: int = 128                # page pool size (incl. scratch)
    prefill_buckets: Tuple[int, ...] = (32, 64, 128)
    decode_buckets: Optional[Tuple[int, ...]] = None  # default: (max_slots,)
    decode_chunk: int = 4              # token boundaries per dispatch
    max_total_tokens: int = 256        # per-request prompt + new cap
    dtype: Optional[str] = "bfloat16"  # None = f32 parity mode
    temperature: float = 0.0           # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None # default; per-request override
    seed: int = 0
    # -- the JAX engine's raw-speed levers and tp plans: not ported ---------
    quant: Optional[object] = None
    speculative_k: int = 0
    prefix_sharing: bool = False
    plan: Optional[object] = None

    def __post_init__(self):
        if self.plan is not None:
            raise NotImplementedError(
                "plan= (tensor-parallel serving) is not ported yet: it "
                "comes with ROADMAP.md queue A item 14")
        # the JAX config's own value checks come first: a value it
        # refuses is refused here too, not reported as unported
        if isinstance(self.quant, str) and self.quant != "int8":
            raise ValueError(
                f"quant={self.quant!r}: only 'int8' (bf16/f32 are the "
                "dtype= cast, not a quant mode)")
        if self.speculative_k < 0:
            raise ValueError(
                f"speculative_k={self.speculative_k} must be >= 0")
        for name, off in (("quant", None), ("speculative_k", 0),
                          ("prefix_sharing", False)):
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"ServingConfig({name}=...) is not ported yet: it "
                    f"comes with {_ITEM11}")
        if self.dtype not in (None, "bfloat16", "float32", "float16"):
            raise ValueError(
                f"dtype={self.dtype!r}: 'bfloat16', 'float16', "
                "'float32' or None (the model's f32, the parity mode)")
        if self.top_p is not None and not 0.0 < float(self.top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {self.top_p}")
        if self.decode_buckets is None:
            self.decode_buckets = (self.max_slots,)
        self.prefill_buckets = tuple(sorted(self.prefill_buckets))
        self.decode_buckets = tuple(sorted(self.decode_buckets))
        if self.decode_buckets[-1] != self.max_slots:
            raise ValueError(
                f"largest decode bucket {self.decode_buckets[-1]} "
                f"must equal max_slots {self.max_slots}")
        if self.max_total_tokens < self.prefill_buckets[-1]:
            raise ValueError(
                f"max_total_tokens={self.max_total_tokens} < largest "
                f"prefill bucket {self.prefill_buckets[-1]}")
        if self.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk={self.decode_chunk} must be >= 1")

    @property
    def table_width(self) -> int:
        """Block-table columns: enough pages for the longest possible
        request (every program signature shares this width)."""
        return -(-self.max_total_tokens // self.block_size)


class ServingEngine:
    """Continuous-batching serving over one GPTForCausalLM, on the
    model's device."""

    def __init__(self, model, config: Optional[ServingConfig] = None):
        self.config = cfg = config or ServingConfig()
        mcfg = model.gpt.config
        if cfg.max_total_tokens > mcfg.max_seq_len:
            raise ValueError(
                f"max_total_tokens={cfg.max_total_tokens} exceeds the "
                f"model's max_seq_len={mcfg.max_seq_len}")
        self.device = next(model.parameters()).device
        self.n_heads = int(mcfg.num_heads)
        # weight snapshot, cast once at engine build into tensors the
        # engine owns; new weights land only through swap_weights(), in
        # place, so no captured program changes
        self.params = build_serving_snapshot(_gpt_params(model), cfg)
        self.eps = float(mcfg.layer_norm_eps)
        self.vocab_size = int(mcfg.vocab_size)
        hd = int(mcfg.hidden_size) // self.n_heads
        self.cache = PagedKVCache(
            n_layers=int(mcfg.num_layers), n_blocks=cfg.n_blocks,
            block_size=cfg.block_size, n_heads=self.n_heads, head_dim=hd,
            dtype=cfg.dtype or self.params["wte"].dtype,
            device=self.device)
        self.ladder = BucketLadder(cfg.prefill_buckets,
                                   cfg.decode_buckets, cfg.block_size)
        self.sched = FifoScheduler(cfg.max_slots, cfg.max_admit)
        sampling = (float(cfg.temperature),
                    None if cfg.top_k is None else int(cfg.top_k),
                    None if cfg.top_p is None else float(cfg.top_p))
        self._decode_fn = make_decode_fn(self.eps, self.n_heads,
                                         cfg.block_size, *sampling,
                                         n_steps=int(cfg.decode_chunk))
        self._prefill_fn = make_prefill_fn(self.eps, self.n_heads,
                                           cfg.block_size, *sampling)
        self.programs = ProgramCache(self.device)
        self.sentinel = RecompileSentinel("serving")
        # the sampling noise's generator (drawn outside the programs)
        self._gen = None
        if cfg.temperature != 0.0:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(cfg.seed))

    # -- program-count contract ----------------------------------------------
    def executable_count(self) -> int:
        """Programs the engine holds: CUDA graphs on the card, eager
        entries on the CPU."""
        return len(self.programs)

    @property
    def expected_executables(self) -> int:
        """The steady-state program budget the sentinel pins: one per
        prefill bucket and one per decode bucket."""
        return self.ladder.size

    # -- request intake ------------------------------------------------------
    def submit(self, ids, max_new_tokens: int, rid=None,
               eos_token_id=None, arrival: Optional[float] = None):
        """Queue one request. Fails loudly on shapes the ladder cannot
        serve: a queued-then-unservable request would wedge FIFO
        admission forever."""
        req = Request(ids=ids, max_new_tokens=int(max_new_tokens),
                      rid=rid,
                      eos_token_id=(self.config.eos_token_id
                                    if eos_token_id is None
                                    else eos_token_id),
                      arrival=(time.perf_counter()
                               if arrival is None else arrival))
        self.ladder.pick_prefill(req.prompt_len)  # raises if too long
        if req.total_tokens > self.config.max_total_tokens:
            raise ValueError(
                f"request needs {req.total_tokens} tokens > "
                f"max_total_tokens={self.config.max_total_tokens}")
        need = self.cache.blocks_for(req.total_tokens)
        if need > self.cache.n_blocks - 1:
            raise ValueError(
                f"request needs {need} pages > pool size "
                f"{self.cache.n_blocks - 1}")
        return self.sched.submit(req)

    def has_work(self) -> bool:
        return self.sched.has_work()

    # -- the dispatches ------------------------------------------------------
    def _noise(self, shape):
        if self._gen is None:
            return None
        return _gumbel(shape, self._gen, self.device)

    def _prefill(self, tables, ids, lens):
        a = ids.shape[0]
        return self.programs("prefill", self._prefill_fn, self.cache.pools,
                             self.params, (tables, ids, lens),
                             self._noise((a, self.vocab_size)))

    def _decode(self, tables, toks, positions):
        b = toks.shape[0]
        return self.programs("decode", self._decode_fn, self.cache.pools,
                             self.params, (tables, toks, positions),
                             self._noise((self.config.decode_chunk, b,
                                          self.vocab_size)))

    # -- the ladder warmup ---------------------------------------------------
    def warmup(self):
        """Build the whole ladder up front on dummy lanes (all-zero
        tables: every write lands in the scratch page). On the card this
        captures every program as a CUDA graph; a server pays that at
        start-up, steady state then replays a fixed set and the sentinel
        flags any growth."""
        cfg = self.config
        w = cfg.table_width
        a = self.sched.max_admit
        for s in self.ladder.prefill:
            self._prefill(np.zeros((a, w), np.int32),
                          np.zeros((a, s), np.int32),
                          np.ones((a,), np.int32))
        for b in self.ladder.decode:
            self._decode(np.zeros((b, w), np.int32),
                         np.zeros((b,), np.int32),
                         np.zeros((b,), np.int32))
        self.sentinel.observe(self.executable_count(),
                              expected=self.expected_executables,
                              signature=self._shape_signature(None, None))
        return self

    # -- one token boundary --------------------------------------------------
    def step(self) -> List[Request]:
        """Retire, admit, decode: returns the requests that finished at
        this boundary (their pages already freed)."""
        cfg = self.config
        finished = self.sched.retire_finished()
        for r in finished:
            self.cache.free(r.rid)
            r.done_ts = time.perf_counter()
        batch = self.sched.take_admissible(self.cache)
        prefill_sig = decode_sig = None
        if batch:
            t0 = time.perf_counter()
            a = self.sched.max_admit
            rids: List[object] = []
            for r in batch:
                self.cache.alloc(r.rid, r.total_tokens)
                rids.append(r.rid)
            rids += [None] * (a - len(batch))
            s = self.ladder.pick_prefill(max(r.prompt_len for r in batch))
            ids = np.zeros((a, s), np.int32)
            lens = np.ones((a,), np.int32)
            for i, r in enumerate(batch):
                ids[i, :r.prompt_len] = r.ids
                lens[i] = r.prompt_len
            tok = self._prefill(
                self.cache.table_array(rids, cfg.table_width), ids, lens)
            prefill_sig = (a, s)
            now = time.perf_counter()
            for i, r in enumerate(batch):
                r.admitted_ts = t0
                r.first_token_ts = now
                r.pos = r.prompt_len
                r.accept(int(tok[i]))

        active = self.sched.active()
        if active:
            b = self.ladder.pick_decode(len(active))
            toks = np.zeros((b,), np.int32)
            positions = np.zeros((b,), np.int32)
            rids = []
            for i, r in enumerate(active):
                toks[i] = r.out[-1]
                positions[i] = r.pos
                rids.append(r.rid)
            rids += [None] * (b - len(active))
            toks_out = self._decode(
                self.cache.table_array(rids, cfg.table_width), toks,
                positions)                              # [chunk, B]
            for i, r in enumerate(active):
                for s in range(toks_out.shape[0]):
                    if r.done:
                        break   # over-decoded junk: the host trims
                    r.pos += 1
                    r.accept(int(toks_out[s, i]))
            decode_sig = (b,)

        if batch or active:
            self.sentinel.observe(
                self.executable_count(),
                expected=self.expected_executables,
                signature=self._shape_signature(prefill_sig, decode_sig))
        return finished

    # -- eviction + hot weight swap ------------------------------------------
    def evict_requests(self) -> List[Request]:
        """Strip every in-flight request off the engine for exact requeue
        elsewhere (a drain before shutdown or handoff). Returns running
        requests (admission order) then queued ones (FIFO); a running
        request keeps ids/pos/out, and since page reservation is
        whole-lifetime, prompt + emitted tokens fully describe it: under
        the f32 greedy parity contract, prefill(prompt + emitted) on
        another engine resumes it exactly. Pages are freed."""
        running = list(self.sched.running.values())
        for r in running:
            self.cache.free(r.rid)
        self.sched.running.clear()
        queued = list(self.sched.queue)
        self.sched.queue.clear()
        return running + queued

    def swap_weights(self, params, cast: bool = True):
        """Install new weights at a token boundary without draining: any
        point between step() calls is one; running requests keep their
        pages and decode their next token under the new weights.

        Validates structure, shapes and dtypes against the current
        snapshot before touching it, then copies the new values into the
        snapshot's tensors in place: every captured program reads them
        at the same addresses, so nothing is recaptured and the sentinel
        stays quiet. cast=True runs ``params`` (generation params, e.g.
        from models.generation._gpt_params) through the engine's
        snapshot build first; cast=False takes a snapshot already in
        the serving dtype."""
        new = build_serving_snapshot(params, self.config) if cast \
            else params
        old_leaves, new_leaves = _leaves(self.params), _leaves(new)
        if [p for p, _ in old_leaves] != [p for p, _ in new_leaves]:
            raise ValueError(
                "weight swap rejected: params tree structure differs "
                "from the serving snapshot (same model family only)")
        for (path, o), (_, n) in zip(old_leaves, new_leaves):
            if tuple(n.shape) != tuple(o.shape) or n.dtype != o.dtype:
                raise ValueError(
                    f"weight swap rejected: {path} is "
                    f"{tuple(n.shape)}/{n.dtype}, serving snapshot holds "
                    f"{tuple(o.shape)}/{o.dtype}: a mismatch would need "
                    "new programs")
        with torch.no_grad():
            for (_, o), (_, n) in zip(old_leaves, new_leaves):
                o.copy_(n)
        return self

    def _shape_signature(self, prefill_sig, decode_sig):
        """Sentinel signature: the bucket shapes this step dispatched
        (a violation's diff then names the drifting bucket)."""
        sig = []
        if prefill_sig is not None:
            sig.append(("prefill", tuple(prefill_sig), "bucket"))
        if decode_sig is not None:
            sig.append(("decode", tuple(decode_sig), "bucket"))
        return tuple(sig)

    # -- convenience drains --------------------------------------------------
    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        """Drain the queue + running set; returns every finished request
        in completion order."""
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            done.extend(self.step())
        else:
            raise RuntimeError(
                f"run_to_completion: work left after {max_steps} "
                "steps (eos never fired and budgets did not expire?)")
        return done

    def generate_tokens(self, prompts: Sequence[np.ndarray],
                        max_new_tokens) -> List[List[int]]:
        """Batch convenience: submit all, drain, return per-prompt
        generated tokens in submit order (the parity-test surface)."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        rids = [self.submit(p, n)
                for p, n in zip(prompts, max_new_tokens)]
        by_rid = {r.rid: r for r in self.run_to_completion()}
        return [list(by_rid[rid].out) for rid in rids]
