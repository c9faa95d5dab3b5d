"""ServingEngine: continuous-batching GPT serving over the paged cache
(counterpart of paddle_tpu/serving/engine.py).

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

Three raw-speed levers compose on top of that loop, each off by
default:

- ``quant="int8"``: the weight snapshot's four block matmul weights
  become per-channel int8 codes + f32 scales (quant/int8_serving.py) and
  every block matmul runs int8 x int8 -> int32; the f32 parity mode
  stays the accuracy reference.
- ``speculative_k=k`` (with ``draft_model=``): the draft proposes k
  greedy tokens in one decode dispatch, the target scores the anchor
  and the k proposals in one chunk dispatch, and the host keeps the
  longest agreeing prefix. Every emitted token is a target argmax over
  a cache that held only accepted tokens, so the streams equal
  non-speculative greedy: speculation changes latency, not output.
- ``prefix_sharing=True``: admission matches the longest radix-indexed
  prompt prefix, points the block table at the shared pages
  (refcounted, copy-on-write) and prefills only the unshared suffix
  through the chunk program.

The engine follows the model's device: a model built on the card serves
from the card, one built with device="cpu" from the CPU.

Telemetry, at the JAX engine's boundaries and under its names, each
gated on its plane's one module bool (nothing is read from the card for
it): the request tracer's submit/dispatch/retire marks and its
admission (scheduler), prefix_match, prefill, draft and decode spans;
the ``serving.*`` counters (admitted, retired, evicted, tokens, prefix
hits, speculative proposed/accepted, weight swaps), histograms (ttft,
prefill and decode step ms) and gauges (queue depth, active slots,
pages); and the OOM sentry around every captured dispatch
(observability.memory.handle_dispatch_oom, then re-raise). Spans carry
the boundary number as their tick. They carry no replica label:
only the fleet sets one in the JAX package (ROADMAP item 10d).

Not ported yet: tensor-parallel plans (``plan=``, ROADMAP.md queue A
item 14).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.generation import _cast_params, _gpt_params, _gumbel
from ..observability import memory as _mem
from ..observability import metrics as _obs
from ..observability import reqtrace as _rt
from ..observability.sentinel import RecompileSentinel
from ..quant.int8_serving import quantize_params
from .paged_cache import PagedKVCache
from .programs import (ProgramCache, make_chunk_fn, make_decode_fn,
                       make_prefill_fn)
from .scheduler import BucketLadder, FifoScheduler, Request

__all__ = ["ServingConfig", "ServingEngine", "build_serving_snapshot"]


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
    float cast to cfg.dtype, then (``quant="int8"``) the four block
    matmul weights as ``{"q8", "s"}`` leaves, all fresh tensors that the
    engine owns (a weight swap copies into them in place; the model's
    own parameters are never written). The one function that engine
    build and ``swap_weights(cast=True)`` share, so a new snapshot
    always has the structure the captured programs read."""
    dtype = None if cfg.dtype is None else getattr(torch, cfg.dtype)
    snap = _cast_params(params, dtype)
    if cfg.quant == "int8":
        snap = quantize_params(snap, cfg.quant_config)
    return _clone(snap)


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
    # -- raw-speed levers (all off by default) -------------------------------
    quant: Optional[object] = None     # "int8" | a config with int8_compute
    speculative_k: int = 0             # draft proposals per boundary
    prefix_sharing: bool = False       # radix/COW shared prompt pages
    # -- tensor parallelism: not ported --------------------------------------
    plan: Optional[object] = None

    def __post_init__(self):
        if self.plan is not None:
            raise NotImplementedError(
                "plan= (tensor-parallel serving) is not ported yet: it "
                "comes with ROADMAP.md queue A item 14")
        self.quant_config = None
        if self.quant is not None and not isinstance(self.quant, str):
            # a quantization config object opts into serving int8
            # through int8_compute (read by name: no quant package is
            # imported for it); its weight_bits sets the code width
            if not getattr(self.quant, "int8_compute", False):
                raise ValueError(
                    "serving quant takes a config with int8_compute=True "
                    "(or the string 'int8')")
            self.quant_config = self.quant
            self.quant = "int8"
        if self.quant not in (None, "int8"):
            raise ValueError(
                f"quant={self.quant!r}: only 'int8' (bf16/f32 are the "
                "dtype= cast, not a quant mode)")
        if self.speculative_k < 0:
            raise ValueError(
                f"speculative_k={self.speculative_k} must be >= 0")
        if self.speculative_k and self.temperature != 0.0:
            raise ValueError(
                "speculative decoding requires greedy (temperature=0): "
                "acceptance keeps the longest prefix agreeing with the "
                "target argmax")
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
    model's device.

    ``draft_model`` (required iff ``config.speculative_k >= 1``): the
    small proposer, any GPTForCausalLM over the same vocabulary on the
    same device; its own paged cache tracks the target position for
    position."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 draft_model=None):
        self.config = cfg = config or ServingConfig()
        mcfg = model.gpt.config
        if cfg.max_total_tokens > mcfg.max_seq_len:
            raise ValueError(
                f"max_total_tokens={cfg.max_total_tokens} exceeds the "
                f"model's max_seq_len={mcfg.max_seq_len}")
        self.device = next(model.parameters()).device
        self.n_heads = int(mcfg.num_heads)
        # weight snapshot, cast (and int8-quantized under quant="int8")
        # once at engine build into tensors the engine owns; new weights
        # land only through swap_weights(), in place, so no captured
        # program changes
        self.params = build_serving_snapshot(_gpt_params(model), cfg)
        self.eps = float(mcfg.layer_norm_eps)
        self.vocab_size = int(mcfg.vocab_size)
        hd = int(mcfg.hidden_size) // self.n_heads
        self.cache = PagedKVCache(
            n_layers=int(mcfg.num_layers), n_blocks=cfg.n_blocks,
            block_size=cfg.block_size, n_heads=self.n_heads, head_dim=hd,
            dtype=cfg.dtype or self.params["wte"].dtype,
            prefix_sharing=cfg.prefix_sharing, device=self.device)
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
        # the chunk program serves both levers (speculative verify at
        # [slots, k+1], shared-prefix suffix prefill at [admit, bucket])
        self._spec_k = int(cfg.speculative_k)
        self._chunk_fn = None
        if cfg.prefix_sharing or self._spec_k:
            self._chunk_fn = make_chunk_fn(self.eps, self.n_heads,
                                           cfg.block_size, *sampling)
        self.draft_cache = self.draft_params = None
        self._draft_prefill_fn = self._draft_decode_fn = None
        # speculative receipts: proposals scored and accepted
        self.spec_proposed = self.spec_accepted = 0
        if self._spec_k:
            self._init_draft(draft_model)
        self.programs = ProgramCache(self.device)
        self.sentinel = RecompileSentinel("serving")
        self._step_no = 0
        # the sampling noise's generator (drawn outside the programs)
        self._gen = None
        if cfg.temperature != 0.0:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(cfg.seed))

    def _init_draft(self, draft_model):
        cfg = self.config
        if draft_model is None:
            raise ValueError(
                "speculative_k >= 1 needs a draft_model: the draft "
                "proposes, the target verifies")
        dcfg = draft_model.gpt.config
        if int(dcfg.vocab_size) != self.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{self.vocab_size}: proposals would not be comparable "
                "token ids")
        if cfg.max_total_tokens > dcfg.max_seq_len:
            raise ValueError(
                f"max_total_tokens={cfg.max_total_tokens} exceeds the "
                f"draft's max_seq_len={dcfg.max_seq_len}")
        ddev = next(draft_model.parameters()).device
        if ddev != self.device:
            raise ValueError(f"draft model on {ddev}, target on "
                             f"{self.device}: they must share a device")
        heads = int(dcfg.num_heads)
        eps = float(dcfg.layer_norm_eps)
        # the draft keeps the plain float cast (no int8): it is small by
        # construction, and its only job is proposal quality
        dtype = None if cfg.dtype is None else getattr(torch, cfg.dtype)
        self.draft_params = _clone(_cast_params(_gpt_params(draft_model),
                                                dtype))
        self.draft_cache = PagedKVCache(
            n_layers=int(dcfg.num_layers), n_blocks=cfg.n_blocks,
            block_size=cfg.block_size, n_heads=heads,
            head_dim=int(dcfg.hidden_size) // heads,
            dtype=cfg.dtype or self.draft_params["wte"].dtype,
            device=self.device)
        greedy = (0.0, None, None)    # proposals are always argmax
        self._draft_prefill_fn = make_prefill_fn(eps, heads,
                                                 cfg.block_size, *greedy)
        # one dispatch proposes all k tokens
        self._draft_decode_fn = make_decode_fn(eps, heads, cfg.block_size,
                                               *greedy,
                                               n_steps=self._spec_k)

    # -- program-count contract ----------------------------------------------
    def executable_count(self) -> int:
        """Programs the engine holds: CUDA graphs on the card, eager
        entries on the CPU (the page-copy program included)."""
        return len(self.programs) + self.cache.copy_executables()

    @property
    def expected_executables(self) -> int:
        """The steady-state program budget the sentinel pins. Levers
        swap programs rather than stack them (sharing replaces the dense
        prefill with chunk suffix prefills and adds the page copy;
        speculation replaces the plain decode with the draft's prefill
        and k-proposal decode and the chunk verify), and chunk programs
        dedupe by shape: a verify width equal to a suffix bucket is one
        program."""
        cfg = self.config
        n = 0
        chunk_shapes = set()
        if cfg.prefix_sharing:
            for s in self.ladder.prefill:
                chunk_shapes.add((self.sched.max_admit, s))
            n += 1                       # the COW page-copy program
        else:
            n += len(self.ladder.prefill)
        if self._spec_k:
            for b in self.ladder.decode:
                chunk_shapes.add((b, self._spec_k + 1))
            n += len(self.ladder.prefill)   # draft prompt prefill
            n += len(self.ladder.decode)    # draft k-proposal decode
        else:
            n += len(self.ladder.decode)
        return n + len(chunk_shapes)

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
        if _rt._enabled:
            # a standalone engine: this call is the request's arrival
            _rt.mark(req.rid, "submit", t=req.arrival)
            _rt.mark(req.rid, "dispatch")
        self.sched.submit(req)
        if _obs._enabled:
            _obs.gauge("serving.queue_depth").set(self.sched.queue_depth)
        return req.rid

    def has_work(self) -> bool:
        return self.sched.has_work()

    # -- the dispatches ------------------------------------------------------
    def _dispatch(self, program, call, **context):
        """call() behind the OOM sentry: an out-of-memory fault leaves
        its counter, breadcrumb and receipt, then propagates."""
        try:
            return call()
        except Exception as e:
            _mem.handle_dispatch_oom(program, e, step=self._step_no,
                                     **context)
            raise

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

    def _chunk(self, tables, ids, starts, lens):
        """-> (all_tok [B, S], picked [B])."""
        b = ids.shape[0]
        return self.programs("chunk", self._chunk_fn, self.cache.pools,
                             self.params, (tables, ids, starts, lens),
                             self._noise((b, self.vocab_size)))

    def _draft_prefill(self, tables, ids, lens):
        return self.programs("draft_prefill", self._draft_prefill_fn,
                             self.draft_cache.pools, self.draft_params,
                             (tables, ids, lens))

    def _draft_decode(self, tables, toks, positions):
        return self.programs("draft_decode", self._draft_decode_fn,
                             self.draft_cache.pools, self.draft_params,
                             (tables, toks, positions))

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

        def lanes(rows, width=None):
            return (np.zeros((rows, w), np.int32),
                    np.zeros((rows,) if width is None else (rows, width),
                             np.int32))

        for s in self.ladder.prefill:
            if cfg.prefix_sharing:
                # sharing serves every admission through the chunk
                # program (starts 0 on a full miss is a dense prefill)
                self._chunk(*lanes(a, s), np.zeros((a,), np.int32),
                            np.ones((a,), np.int32))
            else:
                self._prefill(*lanes(a, s), np.ones((a,), np.int32))
        if cfg.prefix_sharing:
            self.cache.warm_copy()
        for b in self.ladder.decode:
            if self._spec_k:
                # speculation replaces the plain decode with the draft's
                # k-proposal decode and the target's [b, k+1] verify
                self._chunk(*lanes(b, self._spec_k + 1),
                            np.zeros((b,), np.int32),
                            np.ones((b,), np.int32))
                self._draft_decode(*lanes(b), np.zeros((b,), np.int32))
            else:
                self._decode(*lanes(b), np.zeros((b,), np.int32))
        if self._spec_k:
            for s in self.ladder.prefill:
                self._draft_prefill(*lanes(a, s), np.ones((a,), np.int32))
        self.sentinel.observe(self.executable_count(),
                              expected=self.expected_executables,
                              signature=self._shape_signature(None, None))
        return self

    # -- one token boundary --------------------------------------------------
    def step(self) -> List[Request]:
        """Retire, admit, decode: returns the requests that finished at
        this boundary (their pages already freed)."""
        finished = self.sched.retire_finished()
        for r in finished:
            self._free(r)
            r.done_ts = time.perf_counter()
        if _rt._enabled:
            for r in finished:
                _rt.mark(r.rid, "retire", t=r.done_ts,
                         reason=r.finish_reason)
        if _obs._enabled and finished:
            _obs.counter("serving.retired_total").add(len(finished))
        batch = self.sched.take_admissible(
            self.cache,
            () if self.draft_cache is None else (self.draft_cache,))
        self._step_no += 1
        prefill_sig = decode_sig = None
        chunk_sigs: List[Tuple[int, int]] = []
        if batch:
            prefill_sig = self._admit(batch, chunk_sigs)
        active = self.sched.active()
        if active:
            decode_sig = (self._speculate(active, chunk_sigs)
                          if self._spec_k else self._decode_active(active))
        if batch or active:
            self.sentinel.observe(
                self.executable_count(),
                expected=self.expected_executables,
                signature=self._shape_signature(prefill_sig, decode_sig,
                                                chunk_sigs))
        if _obs._enabled:
            _obs.gauge("serving.queue_depth").set(self.sched.queue_depth)
            _obs.gauge("serving.active_slots").set(len(self.sched.active()))
            _obs.gauge("serving.pages_free").set(self.cache.n_free)
            _obs.gauge("serving.pages_live").set(self.cache.n_live)
            if self.config.prefix_sharing:
                _obs.gauge("serving.pages_shared").set(self.cache.n_shared)
        return finished


    def _free(self, r):
        self.cache.free(r.rid)
        if self.draft_cache is not None:
            self.draft_cache.free(r.rid)

    def _admit(self, batch, chunk_sigs):
        """One admission: page allocation (radix-matched under sharing),
        the draft's full-prompt prefill under speculation, then the
        target's prefill (the chunk program over each row's unshared
        suffix under sharing). Returns the dense prefill's signature, or
        None when the chunk program ran."""
        cfg = self.config
        t0 = time.perf_counter()
        a = self.sched.max_admit
        rids: List[object] = []
        for r in batch:
            if cfg.prefix_sharing:
                # the longest indexed prompt prefix rides shared pages
                _, r.shared_tokens = self.cache.alloc_shared(
                    r.rid, r.total_tokens, r.ids)
            else:
                self.cache.alloc(r.rid, r.total_tokens)
            rids.append(r.rid)
        t_match = time.perf_counter()
        rids += [None] * (a - len(batch))
        if self.draft_cache is not None:
            # the draft mirrors the target position for position; its
            # cache never shares, so it prefills the full prompt
            for r in batch:
                self.draft_cache.alloc(r.rid, r.total_tokens)
            ids, lens = self._window(batch, a, 0)
            self._draft_prefill(
                self.draft_cache.table_array(rids, cfg.table_width),
                ids, lens)
        tables = self.cache.table_array(rids, cfg.table_width)
        if cfg.prefix_sharing:
            # each row forwards only its unshared tail, starting at its
            # shared-token offset and attending the shared pages through
            # the table gather (a full miss is starts 0)
            ids, lens = self._window(batch, a, None)
            starts = np.zeros((a,), np.int32)
            for i, r in enumerate(batch):
                starts[i] = r.shared_tokens
            _, tok = self._dispatch(
                "serving_prefill",
                lambda: self._chunk(tables, ids, starts, lens),
                bucket=ids.shape[1], width=a)
            chunk_sigs.append(ids.shape)
            sig = None
        else:
            ids, lens = self._window(batch, a, 0)
            tok = self._dispatch(
                "serving_prefill", lambda: self._prefill(tables, ids, lens),
                bucket=ids.shape[1], width=a)
            sig = ids.shape
        now = time.perf_counter()
        for i, r in enumerate(batch):
            r.admitted_ts = t0
            r.first_token_ts = now
            r.pos = r.prompt_len
            r.accept(int(tok[i]))
        if cfg.prefix_sharing:
            # adopt the prompts' full-chunk pages into the radix index
            # after the prefill landed their K/V: the next request with
            # this prefix shares them
            for r in batch:
                self.cache.register_prefix(r.rid, r.ids)
        s = ids.shape[1]
        if _rt._enabled:
            tick = self._step_no
            for r in batch:
                if r.shared_tokens:
                    # the radix match + shared alloc slice of admission
                    _rt.record_span(r.rid, "prefix_match", t0, t_match,
                                    shared_tokens=r.shared_tokens,
                                    tick=tick)
                _rt.record_span(r.rid, "prefill",
                                t_match if r.shared_tokens else t0, now,
                                bucket=s, width=a, tick=tick)
        if _obs._enabled:
            _obs.counter("serving.admitted_total").add(len(batch))
            _obs.histogram("serving.prefill_ms").observe((now - t0) * 1e3)
            for r in batch:
                if r.arrival is not None:
                    _obs.histogram("serving.ttft_ms").observe(
                        (now - r.arrival) * 1e3)
            if cfg.prefix_sharing:
                hits = sum(1 for r in batch if r.shared_tokens)
                if hits:
                    _obs.counter("serving.prefix_hits_total").add(hits)
                    _obs.counter("serving.prefix_shared_pages_total").add(
                        sum(r.shared_tokens // cfg.block_size
                            for r in batch))
        return sig

    def _window(self, batch, a, start):
        """The admit batch's prompts from ``start`` (None: each row's
        shared-token offset), right-padded to the prefill bucket of the
        longest: ids [a, S], lens [a] (1 on padded lanes)."""
        tails = [r.ids[r.shared_tokens if start is None else start:]
                 for r in batch]
        s = self.ladder.pick_prefill(max(t.size for t in tails))
        ids = np.zeros((a, s), np.int32)
        lens = np.ones((a,), np.int32)
        for i, t in enumerate(tails):
            ids[i, :t.size] = t
            lens[i] = t.size
        return ids, lens

    def _lanes(self, active):
        """Decode lanes of the active set: bucket b, last tokens,
        positions and rids (None on padded lanes)."""
        b = self.ladder.pick_decode(len(active))
        toks = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        rids: List[object] = []
        for i, r in enumerate(active):
            toks[i] = r.out[-1]
            positions[i] = r.pos
            rids.append(r.rid)
        rids += [None] * (b - len(active))
        return b, toks, positions, rids

    def _decode_active(self, active):
        t0 = time.perf_counter()
        b, toks, positions, rids = self._lanes(active)
        tables = self.cache.table_array(rids, self.config.table_width)
        toks_out = self._dispatch(
            "serving_decode", lambda: self._decode(tables, toks, positions),
            bucket=b)                                    # [chunk, B]
        accepted = 0
        for i, r in enumerate(active):
            for s in range(toks_out.shape[0]):
                if r.done:
                    break   # over-decoded junk: the host trims
                r.pos += 1
                r.accept(int(toks_out[s, i]))
                accepted += 1
        if _rt._enabled:
            t1, tick = time.perf_counter(), self._step_no
            for r in active:
                _rt.record_span(r.rid, "decode", t0, t1, bucket=b,
                                chunk=int(toks_out.shape[0]), tick=tick)
        if _obs._enabled:
            _obs.histogram("serving.decode_step_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            _obs.counter("serving.tokens_total").add(accepted)
        return (b,)

    def _speculate(self, active, chunk_sigs):
        """A speculative boundary: the draft proposes k tokens in one
        dispatch, the target scores anchor + proposals in one chunk
        dispatch, the host keeps the longest agreeing prefix. Each
        emitted token is a target argmax over a cache prefix that held
        only accepted tokens, hence equal to sequential greedy."""
        t0 = time.perf_counter()
        k, width = self._spec_k, self.config.table_width
        b, toks, positions, rids = self._lanes(active)
        d_tables = self.draft_cache.table_array(rids, width)
        props = self._dispatch(
            "serving_draft",
            lambda: self._draft_decode(d_tables, toks, positions),
            bucket=b)                                    # [k, B]
        t_draft = time.perf_counter()
        ids = np.zeros((b, k + 1), np.int32)
        lens = np.ones((b,), np.int32)
        for i, r in enumerate(active):
            # emission cap: proposals past the budget are junk the chunk
            # program routes to scratch (lens masks them)
            cap = min(k, r.max_new_tokens - len(r.out))
            ids[i, 0] = r.out[-1]
            ids[i, 1:] = props[:, i]
            lens[i] = cap + 1
        tables = self.cache.table_array(rids, width)
        all_tok, _ = self._dispatch(
            "serving_verify",
            lambda: self._chunk(tables, ids, positions, lens),
            bucket=b)                                    # [B, k+1]
        proposed = accepted = 0
        for i, r in enumerate(active):
            cap = int(lens[i]) - 1
            proposed += cap
            n = 0
            while n < cap:
                tok = int(all_tok[i, n])                 # target argmax
                r.pos += 1
                r.accept(tok)
                n += 1
                if r.done or n >= cap or int(props[n - 1, i]) != tok:
                    break   # the draft diverged: later scores are junk
            accepted += n
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        chunk_sigs.append((b, k + 1))
        if _rt._enabled:
            t1, tick = time.perf_counter(), self._step_no
            for r in active:
                _rt.record_span(r.rid, "draft", t0, t_draft, bucket=b, k=k,
                                tick=tick)
                _rt.record_span(r.rid, "decode", t_draft, t1, bucket=b,
                                chunk=k + 1, tick=tick)
        if _obs._enabled:
            _obs.histogram("serving.decode_step_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            _obs.counter("serving.tokens_total").add(accepted)
            _obs.counter("serving.spec_proposed_total").add(proposed)
            _obs.counter("serving.spec_accepted_total").add(accepted)
            if proposed:
                _obs.gauge("serving.spec_acceptance_rate").set(
                    accepted / proposed)
        return (b,)

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
            self._free(r)
        self.sched.running.clear()
        queued = list(self.sched.queue)
        self.sched.queue.clear()
        evicted = running + queued
        if _obs._enabled and evicted:
            _obs.counter("serving.evicted_total").add(len(evicted))
            _obs.gauge("serving.queue_depth").set(0)
            _obs.gauge("serving.active_slots").set(0)
            _obs.gauge("serving.pages_free").set(self.cache.n_free)
        return evicted

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
        the serving dtype (under quant="int8" with its int8 leaves)."""
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
        if _obs._enabled:
            _obs.counter("serving.weight_swaps_total").add(1)
        return self

    def _shape_signature(self, prefill_sig, decode_sig, chunk_sigs=()):
        """Sentinel signature: the bucket shapes this step dispatched
        (a violation's diff then names the drifting bucket)."""
        sig = []
        if prefill_sig is not None:
            sig.append(("prefill", tuple(prefill_sig), "bucket"))
        if decode_sig is not None:
            sig.append(("decode", tuple(decode_sig), "bucket"))
        for cs in chunk_sigs:
            sig.append(("chunk", tuple(cs), "bucket"))
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
