"""Serving engine: continuous batching over a slot-based cache.

The port's counterpart of ``repro/serving/engine.py``, with its slot and
continuous-batching semantics and its numpy RNG for sampling.

A fixed pool of B slots shares one stacked cache; requests claim a free
slot, are prefilled individually (cache rows copied into their slot), and
all active slots decode together each step with a per-slot position
vector.  Finished slots (EOS or max_new_tokens) free immediately and the
next queued request claims them -- classic continuous batching.  Tokens
are picked on the host from the full padded-vocab logits, as the
reference picks them.

On the card the decode step of every slot is one CUDA graph: the shapes
are fixed per engine (B slots, ``max_seq``), the cache is written in
place, and the tokens and positions go in as (B,) tensors.  The first
step runs eagerly on a side stream and is captured there; each later
step copies its tokens and positions into the graph's input tensors and
replays it, so the host enqueues one graph in place of every layer's
kernels.  A replay launches the same kernels on the same tensors as the
eager step.  On the CPU, and for the families outside
``GRAPH_FAMILIES``, the step stays eager.

``attn_impl`` is the reference's own ``Model.prefill(impl=...)`` argument
(its trainer calls it ``attn_impl``), carried through to the engine: it
picks the attention of each prefill only -- ``"pallas"`` runs the
flash-attention kernel (K4) on the card.  Decode steps keep ``"auto"``: one
call of the kernel takes one query offset, and the slots sit at
different depths.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models.model import Model
from ..runtime import trace

__all__ = ["GRAPH_FAMILIES", "Request", "ServeConfig", "ServingEngine"]

#: Families whose decode step the engine runs as a CUDA graph on the card:
#: the decoder-only ones it serves.  ``vlm`` and ``encdec`` decode against
#: a cross-attention stack that the engine does not hold, and stay eager.
GRAPH_FAMILIES = frozenset({"dense", "moe", "ssm", "hybrid"})


@dataclass
class Request:
    request_id: str
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    done: bool = False


@dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 4
    max_seq: int = 256
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0


class ServingEngine:
    def __init__(self, model: Model, params, cfg: ServeConfig, *, rules=None,
                 device=None, attn_impl: str = "auto"):
        """Serve ``model`` with ``params`` on ``device`` (the card unless
        ``"cpu"`` is asked for; the params must already lie there), its
        prefills through attention ``attn_impl``; ``rules``
        (``distributed.sharding.ShardingRules``) go to every model call."""
        self.model = model
        self.attn_impl = attn_impl
        self.params = params
        self.cfg = cfg
        self.rules = rules
        self.device = resolve_device(device)
        B, T = cfg.batch_slots, cfg.max_seq
        self.cache = model.init_cache(B, T, device=self.device)
        self.positions = np.zeros((B,), np.int32)  # next write index per slot
        self.last_token = np.zeros((B,), np.int32)
        self.slots: List[Optional[Request]] = [None] * B
        self.queue: List[Request] = []
        self._queued_at = {}  # id(request) -> trace.stamp() at submit
        self._rng = np.random.default_rng(cfg.seed)
        # the decode step as one CUDA graph, captured on the first step; it
        # reads the tokens and positions from _tok and _idx, holds the
        # params and cache it was captured with, and writes _logits
        self._graphed = (self.device.type == "cuda"
                         and model.cfg.family in GRAPH_FAMILIES)
        self._graph = None
        if self._graphed:
            self._tok = torch.zeros((B,), dtype=torch.int32, device=self.device)
            self._idx = torch.zeros((B,), dtype=torch.int32, device=self.device)
            self._logits = None

    # -- the two model calls (the reference jits these) ---------------------
    def _prefill(self, tokens: torch.Tensor):
        return self.model.prefill(self.params, tokens, rules=self.rules,
                                  impl=self.attn_impl, max_seq=self.cfg.max_seq)

    def _decode(self, tok: torch.Tensor, idx: torch.Tensor):
        return self.model.decode_step(self.params, tok, idx, self.cache,
                                      rules=self.rules)

    def _decode_slots(self):
        """Decode every slot at its position: ``(logits (B, Vp) on the
        device, how)``, ``how`` being ``"eager"``, ``"capture"`` (this
        step ran eagerly and was captured) or ``"replay"``."""
        if not self._graphed:
            logits, self.cache = self._decode(self._to_device(self.last_token),
                                              self._to_device(self.positions))
            return logits, "eager"
        self._tok.copy_(torch.from_numpy(self.last_token))
        self._idx.copy_(torch.from_numpy(self.positions))
        if self._graph is None:
            return self._capture(), "capture"
        self._graph.replay()
        return self._logits, "replay"

    def _capture(self) -> torch.Tensor:
        """This step's decode run eagerly on a side stream (the capture's
        warm-up: cuBLAS and the allocator set up for that stream), then the
        same call captured there; returns the eager run's logits.  Capture
        runs nothing, so the cache moves one step, as eagerly; a second
        warm-up would move it twice."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            with torch.cuda.stream(side):
                logits, _ = self._decode(self._tok, self._idx)
            main.wait_stream(side)
            with torch.cuda.graph(graph, stream=side):
                self._logits, _ = self._decode(self._tok, self._idx)
        self._graph = graph
        return logits

    # -- request lifecycle ------------------------------------------------
    def submit(self, req: Request) -> None:
        t = trace.stamp()
        if t is not None:
            self._queued_at[id(req)] = t
        self.queue.append(req)

    def _claim_slots(self) -> None:
        for b in range(self.cfg.batch_slots):
            if self.slots[b] is None and self.queue:
                req = self.queue.pop(0)
                trace.record("request.queued",
                             self._queued_at.pop(id(req), None),
                             request_id=req.request_id)
                self._prefill_into_slot(b, req)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(self.device)

    def _prefill_into_slot(self, b: int, req: Request) -> None:
        with trace.span("engine.prefill", request_id=req.request_id):
            logits, cache1, _ = self._prefill(
                self._to_device(req.prompt[None, :]))
            # copy the single-row cache into slot b of the shared cache
            _place(self.cache, cache1, b)
            self.slots[b] = req
            self.positions[b] = len(req.prompt)
            self.last_token[b] = self._pick(_host(logits)[0])
            req.output.append(int(self.last_token[b]))

    def _pick(self, logits: np.ndarray) -> int:
        if self.cfg.greedy:
            return int(np.argmax(logits))
        z = logits / max(self.cfg.temperature, 1e-6)
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    # -- one decode tick ----------------------------------------------------
    def step(self) -> int:
        """Prefill waiting requests into free slots, decode all active ones.

        Returns the number of active slots after the step.
        """
        self._claim_slots()
        active = [b for b in range(self.cfg.batch_slots) if self.slots[b] is not None]
        if not active:
            return 0
        with trace.span("engine.decode", slots=len(active)) as sp:
            logits, how = self._decode_slots()
            if sp is not None:
                sp.attrs["graph"] = how
        with trace.span("engine.logits"):
            logits = _host(logits)
        with trace.span("engine.pick"):
            for b in active:
                req = self.slots[b]
                nxt = self._pick(logits[b])
                req.output.append(nxt)
                self.positions[b] += 1
                self.last_token[b] = nxt
                hit_eos = req.eos_id is not None and nxt == req.eos_id
                full = len(req.output) >= req.max_new_tokens or \
                    self.positions[b] >= self.cfg.max_seq - 1
                if hit_eos or full:
                    req.done = True
                    self.slots[b] = None  # slot freed; cache row is overwritten
        return sum(1 for s in self.slots if s is not None)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self.queue:
                return


def _host(logits: torch.Tensor) -> np.ndarray:
    """Logits as float32 numpy (bf16 → f32 is exact, so argmax ties stay)."""
    return logits.float().cpu().numpy()


def _place(shared, single, b: int) -> None:
    """shared[:, b] = single[:, 0] for every leaf of the cache trees."""
    if isinstance(shared, dict):
        for k in shared:
            _place(shared[k], single[k], b)
    else:
        shared[:, b] = single[:, 0]
