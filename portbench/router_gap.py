"""The reading behind the Mixtral family's routing tie rule (``TAU`` in
``portbench/mixtral_reference.py``), on the card, in one process.

    python3 -m portbench.router_gap --config portbench/configs/<config>.json --seed <n>

Makes the configuration's weights from the seed, runs the port in bf16 over
``--seqs`` random sequences of serve-chat's median prompt length (each
prefilled but its last ``--steps`` rows, which decode one at a time, as a
batcher's step does), records every layer's router logits and the experts
the port chose, runs the plain reference over the same sequences following
those experts at every (row, layer) pair, and prints one JSON line: the
pairs compared, the widest |router logit| difference (by layer too, with
its median and 99th percentile) and 3 x the widest (the rule's ``TAU``),
how many pairs the port routed otherwise than the reference's own top k,
and the widest reference margin among them, which the rule has to cover.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 25)
    p.add_argument("--seqs", type=int, default=6)
    p.add_argument("--len", type=int, default=1020)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at a tiny size")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("router_gap: no CUDA device", file=sys.stderr)
        return 3

    from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
    from llama_nuts_and_bolts_tpu_torch.ops import linear, moe

    from portbench.families import mixtral

    cfg = json.loads(Path(args.config).read_text())
    d = mixtral.dims(cfg)
    w = mixtral.make_weights(d, args.seed, dev)
    model = mixtral.program(w, args.config, args.len, dev, fused=False)
    gen = torch.Generator().manual_seed(args.seed)
    seqs = [torch.randint(0, d.vocab, (args.len,), generator=gen).tolist()
            for _ in range(args.seqs)]

    impl = "flash" if dev.type == "cuda" else "plain"
    logits, log = [], moe.RoutingLog()      # the port's: per sequence [rows, L, E]
    seen: list = []
    route = moe.route

    def recording(h, router, k, live=None):
        ids, weights = route(h, router, k, live)
        seen.append((linear(h, router, out_dtype=torch.float32).float(), ids))
        return ids, weights

    def chosen():
        """The layers' logits ``[rows, L, E]`` and ids ``[rows, L, k]`` seen."""
        return (torch.stack([a for a, _ in seen], dim=1),
                torch.stack([b for _, b in seen], dim=1))

    moe.route = recording
    try:
        with torch.no_grad():
            for j, s in enumerate(seqs):
                cache = KVCache.create(model.cfg, 1, args.len, device=dev)
                tok = torch.tensor([s], dtype=torch.int32, device=dev)
                n = len(s) - args.steps
                seen.clear()
                forward(model.params, model.cfg, tok[:, :n], 0, cache, attn_impl=impl)
                parts = [chosen()]
                for t in range(n, len(s)):
                    seen.clear()
                    forward(model.params, model.cfg, tok[:, t:t + 1], t, cache,
                            attn_impl=impl)
                    parts.append(chosen())
                logits.append(torch.cat([a for a, _ in parts]))
                log.begin(j, s)
                log.add(j, 0, torch.cat([b for _, b in parts]).cpu().numpy())
    finally:
        moe.route = route
    del model

    ref = mixtral.Reference(w, cfg, tau=float("inf"), follow=log)
    ref.record = []
    ref.logits(seqs, [len(s) - 1 for s in seqs])
    k, L = d.top_k, d.n_layers
    port = torch.cat(logits)                                        # [N, L, E]
    mine = torch.cat([torch.from_numpy(log.rows(s, len(s))).to(dev) for s in seqs])
    diffs, otherwise, margins, layers = [], 0, [], []
    for li in range(L):
        r = ref.record[li]
        dl = (r - port[:, li]).abs().amax(-1)
        diffs.append(dl)
        top, own = torch.topk(r, k)
        prog = mine[:, li]
        other = (torch.sort(prog).values != torch.sort(own).values).any(-1)
        otherwise += int(other.sum())
        margins.append((top[:, k - 1:k] - r.gather(1, prog)).amax(-1)[other])
        layers.append([round(float(dl.median()), 5), round(float(torch.quantile(dl, 0.99)), 5),
                       round(float(dl.max()), 5), int(other.sum())])
    diff = torch.cat(diffs)
    widest = float(diff.max())
    margin = torch.cat(margins)
    print(json.dumps({"pairs": int(diff.numel()), "median": float(diff.median()),
                      "p99": float(torch.quantile(diff, 0.99)), "widest": widest,
                      "tau": 3 * widest, "routed_otherwise": otherwise,
                      "widest_margin_otherwise": float(margin.max()) if margin.numel() else 0.0,
                      "by_layer": layers,
                      "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
