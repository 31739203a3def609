"""Paged continuous batching: block-pool memory management for the scheduler.

Port of ``llama_nuts_and_bolts_tpu/runtime/paged.py``. ``PagedBatcher``
replaces the dense batcher's per-slot cache rows with a shared block pool
(``models/llama/paged.py``): a request holds ``pos // bs + 1`` blocks at any
moment, takes them as it decodes and returns them the moment it finishes.

Speculation composes with the pool: each verify step writes K+1 rows a
slot, so the scheduler backs positions pos..pos+K with blocks before the
step and clamps a slot's draft count to what the pool could back -- a dry
pool gives fewer (or no) drafts, never a stall. A step where no slot drafts
runs the plain paged step (its graph, K6 on a card).

Scheduling policy (host side, O(slots) per step):
  * admission needs ``prompt_len // bs + 1`` blocks (prompt + the next write
    position), fewer when the prefix cache revives already-resident prompt
    blocks; requests that do not fit wait in FIFO order, never preempting;
  * decode growth takes one block each time a request crosses a block
    boundary, at dispatch time; if the pool is dry then, the request ends
    gracefully after its current token (FINISHED_BY_REACHING_SEQ_LEN);
  * free slots keep stepping with a pad token into the TRASH block;
  * ``submit`` refuses a prompt the pool can never hold.

Under the engine's tensor-parallel mesh each rank holds its KV heads of the
pool (the pool ``parallel.shard_pool`` cuts from a whole one, made at its
local size), passes the mesh to every paged call, and keeps the allocator,
the tables and the prefix cache whole and equal to every other rank's:
they follow from the step records (``runtime/continuous.py``).
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from llama_nuts_and_bolts_tpu_torch.kernels.attention import HEAD_DIM
from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import paged_kernel_takes
from llama_nuts_and_bolts_tpu_torch.parallel.mesh import tp_size
from llama_nuts_and_bolts_tpu_torch.models.llama.paged import (
    DEFAULT_BLOCK_SIZE,
    TRASH_BLOCK,
    PagedKVPool,
    paged_decode_step,
    paged_decode_step_spec,
    paged_prefill,
    paged_prefill_shared,
)
from llama_nuts_and_bolts_tpu_torch.runtime.block_pool import (
    PrefixBlockAllocator,
    chain_block_hashes,
)
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher, Request


class BlockAllocator:
    """Free-list allocator over pool block ids (block 0 is reserved trash)."""

    def __init__(self, n_blocks: int, block_size: int) -> None:
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: deque[int] = deque(range(1, n_blocks))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (all-or-nothing) if the pool can't supply them."""
        if n < 0 or len(self._free) < n:
            return None
        return [self._free.popleft() for _ in range(n)]

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if not 0 < b < self.n_blocks:
                raise ValueError(f"freeing invalid block id {b}")
        self._free.extend(blocks)


def default_attn_impl(engine, block_size: int = DEFAULT_BLOCK_SIZE) -> str:
    """An engine forced to ``"plain"`` or to the kernels (``"flash"``,
    ``"flash_folded"``) forces the pool's path too; ``"auto"`` takes the JAX
    package's rule (``runtime/paged.py:204-221`` there): K6 (``"flash"``) for
    a bf16 pool on a card whose model fits the kernels, else the gather path
    (``"plain"``). A pool whose ``block_size`` K6 cannot copy (not a
    multiple of 8 up to 64, :func:`paged_kernel_takes`) takes the gather
    path too. ``"probe"`` reads as ``"auto"``: the engine's probe measures
    its own one-row step, as in the JAX package.

    A mesh keeps these rules: on a card a bf16 pool takes K6 on a rank's
    heads (``parallel/kernel_shard.py::tp_paged_flash_decode``). The JAX
    package keeps the gather under a mesh only because its paged kernel had
    no ``shard_map`` wrapper (``runtime/paged.py:213-221`` there); that
    wrapper exists (``parallel/kernel_shard.py:86`` there), and here a
    forced ``"flash"`` under a mesh runs K6 or raises, never the gather."""
    forced = engine.args.attn_impl
    if forced not in ("auto", "probe"):
        return "plain" if forced == "plain" else "flash"
    card = engine.device.type == "cuda" and engine._kernels_viable()
    return ("flash" if card and engine.args.kv_cache_dtype != "int8"
            and paged_kernel_takes(block_size) else "plain")


class PagedBatcher(ContinuousBatcher):
    """Continuous batcher over a paged KV pool.

    Its plain decode step is one replay of the step graph
    (``runtime/continuous.py``'s module docstring): ``paged_decode_step``
    over static feed ``[n_slots, 1]``, positions ``[n_slots]`` and block
    tables ``[n_slots, max_blocks]``, which each dispatch writes in place
    after the quantum's block growth, into static ``[n_slots, vocab]``
    logits that the batcher samples eagerly. It is captured at the first
    dispatch on a card, over this batcher's pool, ``n_slots``,
    ``max_blocks`` and attention path; on the CPU the same body runs
    eagerly. The speculative verify step stays eager.

    ``n_blocks`` sizes the pool (default: every slot at full context);
    ``attn_impl`` picks the attention: ``"flash"`` runs K6 in the decode
    step, which streams only the blocks a row owns, and K1 in the admission
    prefill; ``"plain"`` gathers the blocks and prefills on the fp32 oracle
    (the CPU's path). The default is :func:`default_attn_impl`: on a card
    a bf16 pool takes ``"flash"`` and an int8 pool ``"plain"`` unless the
    engine forces one (``"flash"`` on an int8 pool runs K6's int8 mode, and
    K1 on the prompt's dequantized rows); on the CPU, ``"plain"``. K1 takes
    head_dim 128 only, where K6's plain version takes any width, so a CPU
    batcher forced to ``"flash"`` on a narrower model prefills plainly."""

    def __init__(self, engine, n_slots: int = 8,
                 n_blocks: Optional[int] = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 attn_impl: Optional[str] = None,
                 prefix_cache: bool = True,
                 allocator_backend: str = "auto",
                 speculate_k: int = 0,
                 step_quantum: Optional[int] = None,
                 control=None) -> None:
        attn_impl = attn_impl or default_attn_impl(engine, block_size)
        if attn_impl not in ("plain", "flash"):
            raise ValueError(f"attn_impl must be 'plain' or 'flash', got {attn_impl!r}")
        if (attn_impl == "flash" and engine.device.type == "cuda"
                and not paged_kernel_takes(block_size)):
            raise ValueError(f"attn_impl='flash' on a card needs pool blocks of a multiple "
                             f"of 8 positions up to 64 (K6's copies), got {block_size}")
        self._init_common(engine, n_slots, speculate_k, step_quantum, control)
        kv_is_int8 = engine.args.kv_cache_dtype == "int8"
        self.attn_impl = attn_impl
        self._prefill_impl = attn_impl if self.cfg.head_dim == HEAD_DIM else "plain"
        self.block_size = block_size
        self.max_blocks = math.ceil(self.seq_len / block_size)
        if n_blocks is None:
            n_blocks = 1 + n_slots * self.max_blocks
        self.pool = PagedKVPool.create(self.cfg, n_blocks, block_size,
                                       torch.int8 if kv_is_int8 else torch.bfloat16,
                                       device=self.device, tp=tp_size(self.mesh))
        self.prefix_cache = prefix_cache
        self.allocator = PrefixBlockAllocator(n_blocks, block_size,
                                              backend=allocator_backend)
        self.tables = np.full((n_slots, self.max_blocks), TRASH_BLOCK, np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
        self._stalled: deque[Request] = deque()   # admission order, pool-starved
        self._pos_cap = self.max_blocks * block_size - 1
        self._init_step_graph(self.max_blocks)

    def submit(self, prompt_tokens, **kwargs):
        """Refuse prompts the pool can NEVER hold: they would wait at the
        FIFO head forever and wedge every request behind them."""
        need = len(list(prompt_tokens)) // self.block_size + 1
        capacity = self.allocator.n_blocks - 1
        if need > capacity:
            raise ValueError(
                f"prompt needs {need} KV blocks but the pool only has "
                f"{capacity}; raise --paged-blocks or shorten the prompt")
        return super().submit(prompt_tokens, **kwargs)

    @property
    def has_work(self) -> bool:
        return super().has_work or bool(self._stalled)

    # ------------------------------------------------------------ internal

    def _next_waiting(self) -> Optional[Request]:
        return self._stalled.popleft() if self._stalled else super()._next_waiting()

    def _release_slot(self, slot: int) -> None:
        self.allocator.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self.tables[slot, :] = TRASH_BLOCK
        super()._release_slot(slot)

    def _seat(self, slot: int, req: Request, span) -> bool:
        """Probe the prefix cache, take the blocks, prefill the uncached
        suffix and seat ``req``; False when the pool cannot back it yet (the
        request waits at the FIFO's head, and the attempt's span says
        ``stalled``)."""
        from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

        bs = self.block_size
        params = self.engine.model.params
        plen = len(req.prompt)
        total_needed = plen // bs + 1                  # prompt + next write
        # prefix-cache probe: revive the longest run of resident full
        # prompt blocks, keeping >= 1 suffix token for the logits row
        shared: List[int] = []
        hashes: List[int] = []
        if self.prefix_cache:
            hashes = chain_block_hashes(req.prompt, bs)
            for h in hashes[:(plen - 1) // bs]:
                b = self.allocator.lookup(h)
                if b is None:
                    break
                shared.append(b)
        owned = self.allocator.alloc(total_needed - len(shared))
        if owned is None:
            # FIFO: wait for frees; nothing behind this request may jump it
            if shared:
                self.allocator.release(shared)
            self._stalled.appendleft(req)
            self.admission_stalls += 1
            span.counts["stalled"] = 1
            return False
        blocks = shared + owned
        shared_len = len(shared) * bs
        self._slot_blocks[slot] = blocks
        self.tables[slot, :] = TRASH_BLOCK
        self.tables[slot, :len(blocks)] = blocks
        # prefill length: the bucket rounded up to whole blocks
        suffix = req.prompt[shared_len:]
        bucket = prefill_bucket(len(suffix), self.seq_len)
        bucket = min(-(-bucket // bs) * bs, self.max_blocks * bs)
        impl = self._prefill_impl
        self._seated(req, span, shared_len, len(suffix), bucket, flash=impl == "flash")
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[0, :len(suffix)] = torch.tensor(suffix, dtype=torch.int32)
        padded = padded.to(self.device)
        # .copy(): the table row mutates under later bookkeeping
        table_row = torch.from_numpy(self.tables[slot].copy()).to(self.device)
        self._set_sampling(slot, req)
        if shared:
            logits, _ = paged_prefill_shared(params, self.cfg, padded, shared_len,
                                             len(suffix) - 1, self.pool, table_row,
                                             mesh=self.mesh, attn_impl=impl)
        else:
            logits, _ = paged_prefill(params, self.cfg, padded, plen - 1, self.pool,
                                      table_row, mesh=self.mesh, attn_impl=impl)
        # the sampled token's global position: a cache hit never changes
        # a seeded stream
        first, lp = self._sample(logits, [slot], [plen - 1])
        if self.prefix_cache:
            # full prompt blocks this request filled become shareable;
            # decode-grown blocks never do (unhashed)
            for bi in range(len(shared), plen // bs):
                self.allocator.register(hashes[bi], blocks[bi])
        self._occupy(slot, req, first, lp)
        return True

    def _advance_quantum(self, k: int):
        """Advance every slot ``k`` positions and back each active slot's new
        write positions with blocks before the quantum is dispatched.
        ``force[j][slot]`` means the pool could not back the position after
        step j's token, which is then that request's last (later tokens are
        dropped; their writes went to the trash block)."""
        bs = self.block_size
        fed = np.zeros((k, self.n_slots), np.int32)
        epos = np.zeros((k, self.n_slots), np.int32)
        force = [[False] * self.n_slots for _ in range(k)]
        for j in range(k):
            fed[j] = self._pos
            for slot in range(self.n_slots):
                self._pos[slot] = min(int(self._pos[slot]) + 1, self._pos_cap)
                epos[j, slot] = self._pos[slot]
                if self.slots[slot] is None:
                    continue
                bi = int(self._pos[slot]) // bs
                if bi >= len(self._slot_blocks[slot]) and bi < self.max_blocks:
                    grown = self.allocator.alloc(1)
                    if grown is None:
                        force[j][slot] = True
                    else:
                        self._slot_blocks[slot].extend(grown)
                        self.tables[slot, bi] = grown[0]
        return fed, epos, force

    def _host_tables(self) -> np.ndarray:
        return self.tables

    def _step_fn(self):
        params, cfg, pool = self.engine.model.params, self.cfg, self.pool
        impl, mesh = self.attn_impl, self.mesh

        def step(feed, positions, tables):
            logits, _ = paged_decode_step(params, cfg, feed, positions, pool, tables, impl,
                                          mesh=mesh)
            return logits

        return step

    def _verify_logits(self, toks, positions) -> torch.Tensor:
        tables = torch.from_numpy(self.tables.copy()).to(self.device)
        logits, _ = paged_decode_step_spec(self.engine.model.params, self.cfg, toks,
                                           positions, self.pool, tables, mesh=self.mesh)
        return logits

    def _back_positions(self, slot: int, upto_pos: int) -> int:
        """Grow slot's blocks until position ``upto_pos`` is backed (or the
        pool or the table runs out); returns the highest backed position."""
        bs = self.block_size
        blocks = self._slot_blocks[slot]
        while len(blocks) * bs <= upto_pos and len(blocks) < self.max_blocks:
            grown = self.allocator.alloc(1)
            if grown is None:
                break
            self.tables[slot, len(blocks)] = grown[0]
            blocks.extend(grown)
        return len(blocks) * bs - 1

    def _step_speculative(self) -> None:
        """One speculative iteration over the pool: every slot's feed token
        plus up to K n-gram drafts verify in one ``[B, K+1]`` forward. Before
        it, each speculating slot's positions pos..pos+K are backed with
        blocks, its draft count clamped to what the pool could back; rejected
        rows land in backed blocks past the accepted point and are
        overwritten before they become visible. When no slot drafts, the
        plain paged step runs instead (one row instead of K+1, and K6 on a
        card), and the proposers see its tokens. Emission is the dense
        batcher's chain replay, with the paged growth rule at the chain's
        end."""
        K = self.speculate_k
        with self._lock:
            # drafting and admission need current host state
            self._flush_inflight()
            self._sweep_cancelled()
            self._admit()
            if not any(r is not None for r in self.slots):
                return
            step_tokens = np.tile(self._feed[:, None], (1, K + 1))
            draft_lists: List[List[int]] = [[] for _ in range(self.n_slots)]
            for slot in range(self.n_slots):
                prop = self._proposers[slot] if self.slots[slot] is not None else None
                if prop is None:
                    continue
                p0 = int(self._pos[slot])
                # never back positions past what the context lets a request
                # write (a finishing slot must not starve stalled admissions)
                target = min(p0 + K, self.seq_len - 2)
                backed = self._back_positions(slot, target)
                k_eff = min(K, backed - p0, self.seq_len - p0 - 2)
                if k_eff <= 0:
                    continue
                drafts = prop.propose(k_eff)
                draft_lists[slot] = drafts
                step_tokens[slot, 1:1 + len(drafts)] = drafts

            if not any(draft_lists):
                self._plain_step_locked()
                # the plain step pipelines: drain it, so the feed holds the
                # token the proposers must see
                self._flush_inflight()
                for slot in range(self.n_slots):
                    if self.slots[slot] is not None and self._proposers[slot] is not None:
                        self._proposers[slot].extend([int(self._feed[slot])])
                return

            preds, sampled0, lp = self._verify(step_tokens, self._pos)

            def end_hook(slot):
                # the next write position must be backed before the chain's
                # last token is emitted: a dry pool ends the request
                backed = self._back_positions(slot, int(self._pos[slot]))
                return backed < int(self._pos[slot])

            self._deliver_chains(draft_lists, preds, sampled0, lp, end_hook=end_hook)
