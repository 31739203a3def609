"""Minimal OpenAI-compatible HTTP serving layer (stdlib only).

Port of ``llama_nuts_and_bolts_tpu/serving/server.py``: an OpenAI-style REST
surface over the port's engine and batchers.

Endpoints:
  GET  /health                 — liveness + model info
  GET  /v1/models              — model listing
  POST /v1/completions         — {"prompt", "max_tokens", "temperature", "stream"}
  POST /v1/chat/completions    — {"messages": [{"role","content"}], ...}

``stream: true`` responds as Server-Sent Events with OpenAI-style chunk
objects; the token stream rides the same generator the CLI consumes, so the
UTF-8/emoji-safe detokenizer semantics apply (byte-fallback fragments are
held until codepoints complete).

Concurrency: with ``continuous_slots > 0`` every request rides a
continuous-batching scheduler (``runtime/continuous.py``, or
``runtime/paged.py`` over a paged pool with ``paged_blocks``): concurrent
requests share the same decode steps, each in its own slot, joining and
leaving mid-flight. Otherwise generations serialize on a lock with a
per-request cache; a request's ``seed`` then reseeds the engine's generator
for that request only. With the engine's ``speculate_k`` the batchers
speculate too, and ``/metrics`` and ``/health`` carry their counters.

Tensor parallelism (the engine's ``mesh``, ``--tp N``): every rank builds
the same server over its shards; rank 0 alone opens the socket, and the
followers :meth:`LlamaHTTPServer.follow` it over the gloo control group
(``parallel/launch.py``), so every rank makes the same engine calls:

  * with a batcher, its step records (``runtime/continuous.py``);
  * on the sequential path, rank 0 broadcasts each engine call with its
    arguments before it runs it, under ``_gen_lock``: a blocking request
    (``device_loop.generate_block``, the prewarm's too) or a streamed one
    (``engine.generate_tokens`` with its sampling parameters and seed), and
    the followers run the same call. ``cache_prefix`` runs on every rank
    at start-up, from the same flags.
  * A streamed request whose client goes away, or whose stop sequence
    matches, is still run by rank 0 to its end (its ``max_tokens``, a stop
    token or the context) with the output dropped: the followers are
    already in that generation's collectives, and a stop sent at a step
    boundary would cost a broadcast every token on the latency-bound path,
    where the drain costs at most the request's remaining tokens. The next
    request then starts on every rank together.
  * :meth:`LlamaHTTPServer.shutdown` ends the followers: the batcher's stop
    record, or on the sequential path a ``None`` call.
  * A follower skips only a call the engine refuses (``ValueError``, raised
    before any collective, so rank 0 refused it too). Any other failure
    leaves :meth:`LlamaHTTPServer.follow`, and the process model ends
    every rank (``parallel/launch.py``).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from llama_nuts_and_bolts_tpu_torch.parallel.launch import broadcast, new_control_group
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState
from llama_nuts_and_bolts_tpu_torch.tokenizer import PromptPart
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger


class _HTTPServer(ThreadingHTTPServer):
    # a burst of connects beyond the default listen backlog (5) gets
    # kernel-level RSTs before the admission gate can answer 429 — deepen
    # the backlog so overload is handled by OUR bounded-admission policy,
    # not the TCP stack's
    request_queue_size = 128


def apply_stop_sequences(gen, stops):
    """Wrap a (text, finish) stream with OpenAI `stop`-sequence semantics:
    cut the stream at the first occurrence of any stop string (which may
    straddle piece boundaries — up to max(len)-1 chars are held back until
    they can't be a stop prefix) and report finish_reason "stop". The stop
    text itself is never emitted."""
    if not stops:
        yield from gen
        return
    hold = max(len(s) for s in stops) - 1
    acc = ""
    for text, fin in gen:
        acc += text
        hits = [acc.find(s) for s in stops if s in acc]
        if hits:
            yield acc[:min(hits)], "stop"
            return
        if fin is not None:
            yield acc, fin
            return
        if len(acc) > hold:
            cut = len(acc) - hold
            yield acc[:cut], None
            acc = acc[cut:]
    if acc:
        yield acc, None


class LlamaHTTPServer:
    def __init__(self, engine: InferenceEngine, model_name: str = "llama-3.1-8b-instruct",
                 continuous_slots: int = 0, paged_blocks: int = 0,
                 prefix_cache: bool = True, max_pending: int = 0,
                 token_timeout_s: float = 120.0,
                 step_quantum: Optional[int] = None,
                 control=None):
        self.engine = engine
        self.model_name = model_name
        # max wall-clock wait for ONE token from the batcher before the
        # request is failed cleanly (SSE error chunk / 500, counted in
        # /metrics -- never an uncaught queue.Empty mid-response); prewarm()
        # builds the kernels before the socket opens, so it guards stalls
        self.token_timeout_s = token_timeout_s
        self._gen_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        # bounded admission: at most max_pending generation requests may be
        # in flight (decoding or queued on the batcher/serialization lock);
        # excess requests get an immediate 429 + Retry-After instead of an
        # unbounded handler-thread pileup. 0 = auto: 4x the batcher's slots,
        # or 8 for the serialized single-request engine.
        self.max_pending = max_pending or (
            4 * continuous_slots if continuous_slots > 0 else 8)
        self._inflight = 0
        self._admission_lock = threading.Lock()
        # request/token accounting surfaced at /metrics (Prometheus text)
        self._metrics_lock = threading.Lock()
        self.metrics = {"requests_total": 0, "requests_failed": 0,
                        "requests_rejected": 0,
                        "tokens_generated_total": 0,
                        "generation_seconds_total": 0.0}
        # under a mesh: the control group the followers follow on, and this
        # process's rank in it (0 serves)
        self.control = None
        self.rank = 0
        self._stopped = False
        if engine.mesh is not None:
            import torch.distributed as dist

            self.control = new_control_group() if control is None else control
            self.rank = dist.get_rank(group=self.control)
        self.batcher = None
        if continuous_slots > 0:
            if paged_blocks:
                from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

                self.batcher = PagedBatcher(
                    engine, n_slots=continuous_slots, n_blocks=paged_blocks,
                    prefix_cache=prefix_cache,
                    speculate_k=engine.args.speculate_k,
                    step_quantum=step_quantum, control=self.control)
            else:
                from llama_nuts_and_bolts_tpu_torch.runtime.continuous import (
                    ContinuousBatcher,
                )

                self.batcher = ContinuousBatcher(
                    engine, n_slots=continuous_slots,
                    speculate_k=engine.args.speculate_k,
                    step_quantum=step_quantum, control=self.control)
            if self.rank == 0:
                self.batcher.serve_forever_in_thread()

    # ---------------------------------------------------- tensor parallelism

    def _share(self, call) -> None:
        """Rank 0 under a mesh: send the sequential engine call the
        followers run next (the caller holds ``_gen_lock``)."""
        if self.control is not None:
            broadcast(call, self.control)

    def follow(self) -> None:
        """A follower's whole run: rank 0's step records with a batcher, else
        its sequential engine calls, until the one that stops."""
        if self.batcher is not None:
            self.batcher.follow()
            return
        from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import generate_block

        while (call := broadcast(None, self.control)) is not None:
            try:
                if call[0] == "block":
                    generate_block(self.engine, *call[1:])
                else:
                    for _ in self._sequential_tokens(*call[1:], stats={}):
                        pass
            except ValueError as e:
                # the engine's argument refusals, raised before any
                # collective: rank 0 refused the same call alike. Anything
                # else fails this rank (and so every rank)
                get_logger().debug("follower: %s call refused: %s", call[0], e)

    # ------------------------------------------------------------ requests

    def _tokens_for_completion(self, prompt: str):
        if not prompt.endswith(" "):
            prompt += " "
        return [self.engine.model.vocab.bos_id] + self.engine.tokenize_string(prompt)

    def _tokens_for_chat(self, messages):
        parts = []
        for m in messages:
            role = m.get("role", "user")
            parts.append(PromptPart(header=role, content=m.get("content", "")))
        return self.engine.tokenize(parts)

    def generate_block(self, tokens, max_tokens: int):
        """Non-streaming greedy path. With the continuous batcher, requests
        share decode steps; otherwise one request's greedy loop runs alone
        (runtime/device_loop.py)."""
        if self.batcher is not None:
            req = self.batcher.submit(tokens, max_new_tokens=max_tokens)
            ids, finish = [], "length"
            for state, tok in req.tokens(timeout=self.token_timeout_s):
                ids.append(tok)
                if state == GenerationState.FINISHED_BY_REACHING_EOS:
                    finish = "stop"
        else:
            from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import generate_block

            with self._gen_lock:
                self._share(("block", list(tokens), max_tokens))
                ids, finish = generate_block(self.engine, list(tokens), max_tokens)
        # strip the stop token from the rendered text like the streaming path
        if finish == "stop":
            ids = ids[:-1]
        return self._render_block(ids), finish, len(ids)

    def _render_block(self, ids) -> str:
        """Render a finished token block with STREAM-IDENTICAL semantics:
        replay through the same decoding state machine the SSE path uses, so
        trailing incomplete byte-fallback tokens flush as literal <0xNN>
        text (reference: src/inference/inference.go:134-156) in both modes.
        (The reference's TokenBatchToString drops them, tokenize.go:241-259
        — fine for a TUI's prompt echo, but an API's stream=true/false must
        return byte-identical content; found by tests/test_serving_soak.py.)"""
        return "".join(
            p.decoded_string
            for p in self.engine.generate_string_from_output_tokens(ids)
            if not p.added_to_waiting)

    def generate_block_with_logprobs(self, tokens, max_tokens: int,
                                     temperature: float, top_k: int,
                                     top_p: float, seed, n_logprobs: int):
        """Batcher-backed non-streaming generation that also returns per-token
        top-N logprob info (requires --continuous; the shared decode step
        computes the top-5 log-softmax rows anyway)."""
        if self.batcher is None:
            raise ValueError("logprobs requires continuous batching "
                             "(--continuous N)")
        req = self.batcher.submit(tokens, max_new_tokens=max_tokens,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, seed=self._default_seed(seed),
                                  logprobs=n_logprobs)
        ids, finish = [], "length"
        for state, tok in req.tokens(timeout=self.token_timeout_s):
            ids.append(tok)
            if state == GenerationState.FINISHED_BY_REACHING_EOS:
                finish = "stop"
        entries = list(req.logprobs)
        if finish == "stop":
            ids, entries = ids[:-1], entries[:-1]
        return self._render_block(ids), finish, ids, entries

    def render_token(self, token_id: int) -> str:
        """Single-token text for logprobs fields: UTF-8 when the piece decodes
        cleanly, the reference's <0xNN> byte-fallback rendering otherwise
        (keeps distinct token ids distinct as dict keys)."""
        piece = self.engine.model.vocab.piece(token_id)
        if piece is None:
            return f"<unk:{token_id}>"
        try:
            return piece.decode("utf-8")
        except UnicodeDecodeError:
            return "".join(f"<0x{b:02X}>" for b in piece)

    @staticmethod
    def _default_seed(seed):
        """OpenAI semantics: absent seed = fresh entropy per request."""
        if seed is not None:
            return int(seed)
        import os as _os

        return int.from_bytes(_os.urandom(8), "big")

    def _finish_of(self, part):
        """Map a GeneratedPart to (finish_reason|None, text): the shared
        terminal-state mapping + stop-token text suppression used by every
        streaming variant."""
        finish = None
        if part.generation_state == GenerationState.FINISHED_BY_REACHING_EOS:
            finish = "stop"
        elif part.generation_state == GenerationState.FINISHED_BY_REACHING_SEQ_LEN:
            finish = "length"
        text = part.decoded_string
        if finish == "stop" and self.engine.model.vocab.is_stop(part.token_id):
            text = ""   # never surface the stop token's piece
        return finish, text

    def generate_stream_logprobs(self, tokens, max_tokens: int,
                                 temperature: float, top_k: int, top_p: float,
                                 seed, n_logprobs: int, stats=None):
        """Streaming generation with per-token logprobs: yields
        (text_piece, finish_reason|None, entries) where ``entries`` are the
        OpenAI-style logprob records for exactly the tokens this piece
        consumed — byte-fallback tokens still buffered in the detokenizer
        ride with the piece that flushes them, so text and logprobs stay
        aligned. Batcher-only (the shared decode step computes the top-5
        rows anyway); the stop-sequence holdback re-chunks text and is
        rejected with this mode at the API layer."""
        if self.batcher is None:
            raise ValueError("streamed logprobs require continuous batching "
                             "(--continuous N)")
        if stats is None:
            stats = {}
        req = self.batcher.submit(tokens, max_new_tokens=max_tokens,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, seed=self._default_seed(seed),
                                  logprobs=n_logprobs)
        vocab = self.engine.model.vocab
        consumed = 0
        pending = []

        def entry_for(idx):
            # the scheduler records a token's logprobs BEFORE placing it on
            # the request queue, so the entry exists by consumption time
            tok, chosen, tops = req.logprobs[idx]
            return {"token": self.render_token(tok), "logprob": chosen,
                    "top_logprobs": [
                        {"token": self.render_token(i), "logprob": v}
                        for i, v in tops[:n_logprobs]]}

        try:
            for part in self.engine._generate_string(req.tokens(timeout=self.token_timeout_s)):
                stats["tokens"] = req.produced
                if not part.is_resend_of_waiting:
                    # stop tokens never surface in content; skip their entry
                    if not vocab.is_stop(part.token_id):
                        pending.append(entry_for(consumed))
                    consumed += 1
                if part.added_to_waiting:
                    continue
                finish, text = self._finish_of(part)
                entries, pending = pending, []
                yield text, finish, entries
                if finish is not None:
                    return
            yield "", "length", pending
        finally:
            stats["tokens"] = req.produced
            req.cancel()   # no-op if already finished

    def generate(self, tokens, max_tokens: int, temperature: float,
                 top_k: int = 0, top_p: float = 1.0, seed=None,
                 stats=None):
        """Generation; yields (text_piece, finish_reason|None).

        With the continuous batcher enabled EVERY request rides it — greedy
        and sampled alike (each slot samples row-wise with its own
        parameters and seed); otherwise generations serialize on a lock.
        ``stats`` (optional dict) receives {"tokens": N} with the true
        generated-token count (text pieces != tokens once stop-sequence
        holdback or byte-fallback buffering is in play). If the consumer
        stops early (stop sequence, client disconnect), the underlying
        batcher request is cancelled so its slot and blocks free up."""
        if stats is None:
            stats = {}
        if self.batcher is not None:
            req = self.batcher.submit(tokens, max_new_tokens=max_tokens,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p,
                                      seed=self._default_seed(seed))
            try:
                for part in self.engine._generate_string(req.tokens(timeout=self.token_timeout_s)):
                    stats["tokens"] = req.produced
                    if part.added_to_waiting:
                        continue
                    finish, text = self._finish_of(part)
                    yield text, finish
                    if finish is not None:
                        return
                yield "", "length"
                return
            finally:
                stats["tokens"] = req.produced
                req.cancel()   # no-op if already finished
        with self._gen_lock:
            call = (list(tokens), max_tokens, temperature, top_k, top_p, seed)
            self._share(("stream",) + call)
            toks = self._sequential_tokens(*call, stats=stats)
            try:
                for part in self.engine._generate_string(toks):
                    if part.added_to_waiting:
                        continue
                    finish, text = self._finish_of(part)
                    yield text, finish
                    if finish is not None:
                        return
                yield "", "length"
                return
            finally:
                if self.control is not None:
                    # the followers run this generation to its end: so does
                    # rank 0 (the module docstring), without counting it
                    n = stats.get("tokens", 0)
                    for _ in toks:
                        pass
                    stats["tokens"] = n
                toks.close()

    def _sequential_tokens(self, tokens, max_tokens: int, temperature: float,
                           top_k: int, top_p: float, seed, stats):
        """The sequential engine's (state, token) stream of one request with
        its sampling parameters and seed, restored after; every rank runs
        the same. Capped at the TOKEN level (a byte-fallback token that only
        joins the waiting buffer still consumed a decode step and counts
        toward max_tokens); ending the stream here lets _generate_string
        flush pending incomplete bytes as <0xNN> literals, exactly like the
        batcher stream and the block path (_render_block) do."""
        args = self.engine.args
        old = (args.temperature, args.top_k, args.top_p)
        args.temperature, args.top_k, args.top_p = temperature, top_k, top_p
        gen = self.engine._generator
        old_rng = gen.get_state()
        if seed is not None:
            gen.manual_seed(int(seed) & ((1 << 64) - 1))
        try:
            n = 0
            # max_new_tokens both caps the stream and buckets the request's
            # cache buffer (engine.cache_bucket)
            for state, tok in self.engine.generate_tokens(tokens, max_new_tokens=max_tokens):
                n += 1
                stats["tokens"] = n
                yield state, tok
                if n >= max_tokens or state != GenerationState.IN_PROGRESS:
                    return
        finally:
            args.temperature, args.top_k, args.top_p = old
            gen.set_state(old_rng)

    # ------------------------------------------------------------- plumbing

    def try_admission(self) -> bool:
        """Admit one generation request if under the max_pending bound."""
        with self._admission_lock:
            if self._inflight >= self.max_pending:
                return False
            self._inflight += 1
            return True

    def release_admission(self) -> None:
        with self._admission_lock:
            self._inflight -= 1

    def count_request(self, n_tokens: int, seconds: float, failed: bool = False):
        with self._metrics_lock:
            self.metrics["requests_total"] += 1
            self.metrics["requests_failed"] += int(failed)
            self.metrics["tokens_generated_total"] += n_tokens
            self.metrics["generation_seconds_total"] += seconds

    def render_metrics(self) -> str:
        """Prometheus text exposition: counters plus live batcher gauges."""
        m = dict(self.metrics)
        lines = [
            "# TYPE llama_requests_total counter",
            f"llama_requests_total {m['requests_total']}",
            "# TYPE llama_requests_failed_total counter",
            f"llama_requests_failed_total {m['requests_failed']}",
            "# TYPE llama_tokens_generated_total counter",
            f"llama_tokens_generated_total {m['tokens_generated_total']}",
            "# TYPE llama_generation_seconds_total counter",
            f"llama_generation_seconds_total {m['generation_seconds_total']:.3f}",
            "# TYPE llama_requests_rejected_total counter",
            f"llama_requests_rejected_total {m['requests_rejected']}",
            "# TYPE llama_inflight_requests gauge",
            f"llama_inflight_requests {self._inflight}",
            "# TYPE llama_max_pending gauge",
            f"llama_max_pending {self.max_pending}",
            # the engine's decode graphs: an eviction means a later request
            # in that cache bucket captures its graph again
            "# TYPE llama_decode_graphs_built_total counter",
            f"llama_decode_graphs_built_total {self.engine.graphs_built}",
            "# TYPE llama_decode_graph_evictions_total counter",
            f"llama_decode_graph_evictions_total {self.engine.graph_evictions}",
        ]
        if self.batcher is not None:
            b = self.batcher
            lines += [
                "# TYPE llama_batch_slots gauge",
                f"llama_batch_slots {b.n_slots}",
                "# TYPE llama_batch_slots_active gauge",
                f"llama_batch_slots_active {sum(r is not None for r in b.slots)}",
                "# TYPE llama_batch_pending gauge",
                f"llama_batch_pending {b.pending.qsize()}",
                "# TYPE llama_batch_decode_steps_total counter",
                f"llama_batch_decode_steps_total {b.decode_steps}",
                # decode steps replayed from the batcher's captured step graph
                "# TYPE llama_batch_graph_steps_total counter",
                f"llama_batch_graph_steps_total {b.graph_steps}",
                # occupancy = rows / decode steps; padding waste; mean queue
                # wait = wait seconds / admissions
                "# TYPE llama_batch_rows_stepped_total counter",
                f"llama_batch_rows_stepped_total {b.rows_stepped}",
                "# TYPE llama_batch_prefill_tokens_total counter",
                f"llama_batch_prefill_tokens_total {b.prefill_tokens}",
                "# TYPE llama_batch_prefill_padded_tokens_total counter",
                f"llama_batch_prefill_padded_tokens_total {b.prefill_padded_tokens}",
                "# TYPE llama_batch_prefill_cached_tokens_total counter",
                f"llama_batch_prefill_cached_tokens_total {b.prefill_cached_tokens}",
                # admission prefills whose attention ran on K1
                "# TYPE llama_batch_prefill_flash_total counter",
                f"llama_batch_prefill_flash_total {b.prefill_flash}",
                "# TYPE llama_batch_admissions_total counter",
                f"llama_batch_admissions_total {b.admissions}",
                "# TYPE llama_batch_admission_stalls_total counter",
                f"llama_batch_admission_stalls_total {b.admission_stalls}",
                "# TYPE llama_batch_queue_wait_seconds_total counter",
                f"llama_batch_queue_wait_seconds_total {b.queue_wait_s:.6f}",
            ]
            if b.speculate_k:
                # acceptance = accepted / drafted decides whether --speculate
                # pays for a workload
                s = b.spec_stats_snapshot()
                lines += [
                    "# TYPE llama_spec_drafted_total counter",
                    f"llama_spec_drafted_total {s['drafted']}",
                    "# TYPE llama_spec_accepted_total counter",
                    f"llama_spec_accepted_total {s['accepted']}",
                    "# TYPE llama_spec_verify_steps_total counter",
                    f"llama_spec_verify_steps_total {s['spec_steps']}",
                ]
            if hasattr(b, "allocator"):
                lines += [
                    "# TYPE llama_kv_blocks_free gauge",
                    f"llama_kv_blocks_free {b.allocator.available}",
                    "# TYPE llama_kv_blocks_total gauge",
                    f"llama_kv_blocks_total {b.allocator.n_blocks - 1}",
                ]
                s = getattr(b.allocator, "stats", None)
                if s:
                    lines += [
                        "# TYPE llama_prefix_cache_lookups_total counter",
                        f"llama_prefix_cache_lookups_total {s['prefix_lookups']}",
                        "# TYPE llama_prefix_cache_hits_total counter",
                        f"llama_prefix_cache_hits_total {s['prefix_hits']}",
                        "# TYPE llama_prefix_cache_evictions_total counter",
                        f"llama_prefix_cache_evictions_total {s['evictions']}",
                        "# TYPE llama_prefix_cached_blocks gauge",
                        f"llama_prefix_cached_blocks {s['cached_blocks']}",
                    ]
        return "\n".join(lines) + "\n"

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                get_logger().debug("http: " + fmt, *args)

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    info = {"status": "ok", "model": server_self.model_name,
                            "model_type": server_self.engine.model.cfg.model_type}
                    if server_self.batcher is not None:
                        b = server_self.batcher
                        info["continuous"] = {
                            "slots": b.n_slots,
                            "active": sum(r is not None for r in b.slots),
                            "pending": b.pending.qsize(),
                        }
                        if b.speculate_k:
                            s = b.spec_stats_snapshot()
                            info["continuous"]["speculation"] = {
                                "k": b.speculate_k,
                                "drafted": s["drafted"],
                                "accepted": s["accepted"],
                                "acceptance": (round(s["accepted"] / s["drafted"], 4)
                                               if s["drafted"] else None),
                            }
                        if hasattr(b, "allocator"):
                            info["continuous"]["paged"] = {
                                "block_size": b.block_size,
                                "blocks_total": b.allocator.n_blocks - 1,
                                "blocks_free": b.allocator.available,
                                "stalled": len(b._stalled),
                            }
                            s = getattr(b.allocator, "stats", None)
                            if s:
                                info["continuous"]["paged"]["prefix_cache"] = s
                    self._json(200, info)
                elif self.path == "/metrics":
                    body = server_self.render_metrics().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": server_self.model_name, "object": "model"}]})
                else:
                    self._json(404, {"error": {"message": f"unknown path {self.path}"}})

            def do_POST(self):
                # bounded admission: generation work is admitted up to max_pending;
                # beyond that the server answers 429 immediately instead of
                # piling handler threads onto the scheduler/serialization
                # lock. Parse/validation errors never consume a slot.
                self._admitted = False
                try:
                    self._post_impl()
                finally:
                    if self._admitted:
                        server_self.release_admission()

            def _post_impl(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": {"message": f"bad request body: {e}"}})
                    return

                is_chat = self.path == "/v1/chat/completions"
                if not is_chat and self.path != "/v1/completions":
                    self._json(404, {"error": {"message": f"unknown path {self.path}"}})
                    return
                try:
                    if is_chat:
                        messages = req.get("messages")
                        if not isinstance(messages, list) or not messages:
                            raise ValueError("'messages' must be a non-empty list")
                        tokens = server_self._tokens_for_chat(messages)
                    else:
                        prompt = req.get("prompt")
                        if not isinstance(prompt, str) or not prompt:
                            raise ValueError("'prompt' must be a non-empty string")
                        tokens = server_self._tokens_for_completion(prompt)
                except ValueError as e:
                    self._json(400, {"error": {"message": str(e)}})
                    return

                try:
                    max_tokens = int(req.get("max_tokens", 128))
                    temperature = float(req.get("temperature", 0.0))
                    top_p = float(req.get("top_p", 1.0))
                    top_k = int(req.get("top_k", 0))       # extension param
                    seed = req.get("seed")                 # OpenAI seed param
                    if seed is not None:
                        seed = int(seed)
                    n_logprobs = 0                         # 0 = off
                    if is_chat:
                        if bool(req.get("logprobs", False)):
                            n_logprobs = int(req.get("top_logprobs", 1) or 1)
                    elif req.get("logprobs") is not None:
                        n_logprobs = int(req.get("logprobs"))
                    if not 0 <= n_logprobs <= 5:
                        raise ValueError("logprobs must be in [0, 5]")
                    stop = req.get("stop")                 # str | list[str]
                    if isinstance(stop, str):
                        stop = [stop]
                    if stop is not None and (
                            not isinstance(stop, list) or len(stop) > 4
                            or not all(isinstance(s, str) and s for s in stop)):
                        raise ValueError("'stop' must be a non-empty string "
                                         "or a list of up to 4 of them")
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": {"message": f"bad parameter: {e}"}})
                    return
                stream = bool(req.get("stream", False))
                if n_logprobs and server_self.batcher is None:
                    self._json(400, {"error": {"message":
                        "logprobs requires the server to run with --continuous"}})
                    return
                if n_logprobs and stream and stop:
                    self._json(400, {"error": {"message":
                        "streamed logprobs are not supported together with "
                        "'stop' sequences (the stop holdback re-chunks text "
                        "and would misalign token-level logprobs)"}})
                    return
                if not server_self.try_admission():
                    with server_self._metrics_lock:
                        server_self.metrics["requests_rejected"] += 1
                    body = json.dumps({"error": {
                        "message": ("server overloaded: "
                                    f"{server_self.max_pending} requests "
                                    "already admitted; retry shortly"),
                        "type": "overloaded_error"}}).encode("utf-8")
                    self.send_response(429)
                    self.send_header("Retry-After", "1")
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._admitted = True
                rid = f"cmpl-{uuid.uuid4().hex[:20]}"
                created = int(time.time())
                t_start = time.perf_counter()
                gen_stats = {"tokens": 0}
                if stream and n_logprobs:
                    gen = server_self.generate_stream_logprobs(
                        tokens, max_tokens, temperature, top_k, top_p, seed,
                        n_logprobs, stats=gen_stats)
                else:
                    gen = apply_stop_sequences(
                        server_self.generate(tokens, max_tokens, temperature,
                                             top_k=top_k, top_p=top_p,
                                             seed=seed, stats=gen_stats),
                        stop)

                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(data: str) -> None:
                        payload = f"data: {data}\n\n".encode("utf-8")
                        self.wfile.write(f"{len(payload):x}\r\n".encode())
                        self.wfile.write(payload + b"\r\n")

                    counted = False
                    try:
                        for item in gen:
                            if n_logprobs:
                                text, fin, entries = item
                            else:
                                (text, fin), entries = item, None
                            choice = ({"index": 0, "delta": {"content": text},
                                       "finish_reason": fin}
                                      if is_chat else
                                      {"index": 0, "text": text, "finish_reason": fin})
                            if entries is not None:
                                if is_chat:
                                    choice["logprobs"] = {"content": entries}
                                else:
                                    # legacy completions wire format
                                    choice["logprobs"] = {
                                        "tokens": [e["token"] for e in entries],
                                        "token_logprobs": [e["logprob"]
                                                           for e in entries],
                                        "top_logprobs": [
                                            {t["token"]: t["logprob"]
                                             for t in e["top_logprobs"]}
                                            for e in entries],
                                    }
                            chunk(json.dumps({
                                "id": rid, "created": created,
                                "object": ("chat.completion.chunk" if is_chat
                                           else "text_completion"),
                                "model": server_self.model_name,
                                "choices": [choice]}))
                        gen.close()   # early stop: cancel the batcher request
                        # counted before [DONE]: a client that has read the
                        # end of the stream finds the request in /metrics
                        server_self.count_request(
                            gen_stats["tokens"], time.perf_counter() - t_start)
                        counted = True
                        chunk("[DONE]")
                        self.wfile.write(b"0\r\n\r\n")
                    except Exception as e:
                        # headers are already on the wire, so no 500 is
                        # possible: emit a final SSE error chunk, terminate
                        # the chunked body, and count the failure so
                        # /metrics sees it (mirrors the non-stream branch)
                        get_logger().error("stream generation failed: %s", e)
                        try:
                            chunk(json.dumps({"error": {
                                "message": f"generation failed: {e}",
                                "type": "server_error"}}))
                            chunk("[DONE]")
                            self.wfile.write(b"0\r\n\r\n")
                        except OSError:
                            pass   # client already gone
                        gen.close()
                        if not counted:
                            server_self.count_request(
                                0, time.perf_counter() - t_start, failed=True)
                    return
                try:
                    lp_field = None
                    if n_logprobs:
                        full, finish, ids, entries = (
                            server_self.generate_block_with_logprobs(
                                tokens, max_tokens, temperature, top_k,
                                top_p, seed, n_logprobs))
                        if stop:
                            hits = [full.find(s) for s in stop if s in full]
                            if hits:
                                cut = min(hits)
                                full, finish = full[:cut], "stop"
                                # keep only tokens whose rendered prefix fits
                                # the cut so logprobs align with the text
                                keep = 0
                                while keep < len(ids):
                                    _p, s = server_self.engine.token_batch_to_string(
                                        ids[:keep + 1])
                                    if len(s) > cut:
                                        break
                                    keep += 1
                                ids, entries = ids[:keep], entries[:keep]
                        pieces = [None] * len(ids)
                        if is_chat:
                            lp_field = {"content": [
                                {"token": server_self.render_token(t),
                                 "logprob": clp,
                                 "top_logprobs": [
                                     {"token": server_self.render_token(i),
                                      "logprob": v} for i, v in tops]}
                                for t, clp, tops in entries]}
                        else:
                            lp_field = {
                                "tokens": [server_self.render_token(t)
                                           for t, _, _ in entries],
                                "token_logprobs": [clp for _, clp, _ in entries],
                                "top_logprobs": [
                                    {server_self.render_token(i): v
                                     for i, v in tops}
                                    for _, _, tops in entries],
                            }
                    elif temperature == 0.0:
                        # greedy non-streaming: a batcher slot or the
                        # serialized greedy loop; block rendering in both
                        full, finish, n_out = server_self.generate_block(
                            tokens, max_tokens)
                        if stop:
                            hits = [full.find(s) for s in stop if s in full]
                            if hits:
                                full, finish = full[:min(hits)], "stop"
                        pieces = [None] * n_out
                    else:
                        pieces, finish = [], "length"
                        for text, fin in gen:
                            pieces.append(text)
                            if fin:
                                finish = fin
                        gen.close()   # early stop: cancel the batcher request
                        full = "".join(pieces)
                        pieces = [None] * gen_stats["tokens"]
                except Exception as e:  # generation failure -> 500
                    get_logger().error("generation failed: %s", e)
                    server_self.count_request(0, time.perf_counter() - t_start,
                                              failed=True)
                    self._json(500, {"error": {"message": f"generation failed: {e}"}})
                    return
                if is_chat:
                    choice = {"index": 0, "finish_reason": finish,
                              "message": {"role": "assistant", "content": full}}
                else:
                    choice = {"index": 0, "finish_reason": finish, "text": full}
                if lp_field is not None:
                    choice["logprobs"] = lp_field
                # counted before the response is written, as the stream is
                server_self.count_request(len(pieces), time.perf_counter() - t_start)
                self._json(200, {
                    "id": rid, "created": created,
                    "object": "chat.completion" if is_chat else "text_completion",
                    "model": server_self.model_name,
                    "choices": [choice],
                    "usage": {"prompt_tokens": len(tokens),
                              "completion_tokens": len(pieces)},
                })

        return Handler

    def prewarm(self) -> float:
        """Run one short request BEFORE the socket opens: it builds and loads
        the CUDA kernels the path launches (``kernels/build.py``) and warms
        the allocator, so the first client does not pay for them against
        ``token_timeout_s``. Returns the warm-up's elapsed seconds (logged)."""
        t0 = time.perf_counter()
        tokens = [self.engine.model.vocab.bos_id, 1]
        if self.batcher is not None:
            req = self.batcher.submit(tokens, max_new_tokens=3)
            # the batcher thread is already stepping; just drain (no timeout:
            # a cold compile may take minutes and that is exactly the point)
            for _state, _tok in req.tokens(timeout=None):
                pass
        else:
            from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import (
                generate_block,
            )

            with self._gen_lock:
                self._share(("block", tokens, 16))
                generate_block(self.engine, tokens, 16)
        dt = time.perf_counter() - t0
        get_logger().info("prewarm: one request in %.1fs", dt)
        return dt

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000,
                      prewarm: bool = True):
        if prewarm:
            self.prewarm()
        self._httpd = _HTTPServer((host, port), self.make_handler())
        get_logger().info("Serving %s on http://%s:%d", self.model_name, host, port)
        try:
            self._httpd.serve_forever()
        finally:
            if self.control is not None:
                self.shutdown()      # the followers end with this rank

    def start_background(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start in a daemon thread; returns the bound port (0 ⇒ ephemeral)."""
        self._httpd = _HTTPServer((host, port), self.make_handler())
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self._httpd.server_address[1]

    def shutdown(self):
        """Stop serving: the HTTP loop, then the batcher's thread; under a
        mesh the followers' :meth:`follow` ends with it."""
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._stopped:
            return
        self._stopped = True
        if self.batcher is not None:
            self.batcher.stop()
        elif self.control is not None and self.rank == 0:
            with self._gen_lock:
                self._share(None)


def serve(engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000,
          model_name: str = "llama-3.1-8b-instruct", continuous_slots: int = 0,
          paged_blocks: int = 0, prefix_cache: bool = True,
          max_pending: int = 0, prewarm: bool = True,
          token_timeout_s: float = 120.0, step_quantum=None, control=None):
    """Serve until interrupted; under the engine's mesh a follower rank
    follows rank 0 instead (``control``: the gloo control group)."""
    srv = LlamaHTTPServer(engine, model_name, continuous_slots=continuous_slots,
                          paged_blocks=paged_blocks, prefix_cache=prefix_cache,
                          max_pending=max_pending,
                          token_timeout_s=token_timeout_s,
                          step_quantum=step_quantum, control=control)
    if srv.rank != 0:
        srv.follow()
    else:
        srv.serve_forever(host, port, prewarm=prewarm)
