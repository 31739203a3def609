"""Multi-process (multi-host style) execution of the PyTorch port.

As tests/test_multiprocess.py launches two OS processes of the JAX package,
this launches four independent processes of the port -- standing in for two
"hosts" of two processes each -- with the coordinator's address and each
process id in their environment (``subprocess.Popen``, not the CLI's
launcher nor ``tests/tp_workers.py::spawn``). They meet through
``initialize_multihost``, build one ``(dp 2, tp 2)`` mesh over all four
(each "host" one dp row: its two processes the tp pair), and prefill a
batch of two prompts, then take one greedy decode step:

  * on the constructed-cyclic model, every process's tokens (both rows,
    gathered over dp) equal the single-process port run's and the JAX
    package's single-process run's on the same weights, exactly;
  * on random weights, every row's logits lie within ``REL_L2_SINGLE`` of
    the single-process port forward and ``REL_L2_JAX`` of JAX's (the
    readings of tests/test_torch_tp.py), and the tp pair of a row holds
    the same logits, bit for bit.

Each process has its own time limit: it dumps its stacks and exits past
it, and the test kills any process still running after it.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import params_from_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port
from tests.test_torch_engine import CYCLE, PROMPT
from tests.test_torch_quant_model import leaves
from tests.test_torch_tp import REL_L2_JAX, REL_L2_SINGLE, SPEC, cyclic_unfused, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120                  # each process's own limit
PROMPTS = [PROMPT, PROMPT[:-2] + [0x82, 0xAC]]     # end in 72 and 0xAC: the cycle
T = 32


def reference(jcfg, jparams):
    """The JAX package's and the port's single-process runs: both rows'
    (first, second) greedy tokens and the logits of both steps."""
    cfg = ModelArgs(**{k: getattr(jcfg, k) for k in (
        "dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "multiple_of", "norm_eps",
        "max_sequence_length")})
    params = params_from_numpy(leaves(jparams), "cpu")
    jl, jcache = jmodel.forward(jparams, jcfg, jnp.asarray(PROMPTS, jnp.int32), 0,
                                jmodel.KVCache.create(jcfg, 2, T))
    jfirst = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    jl2, _ = jmodel.forward(jparams, jcfg, jnp.asarray(jfirst[:, None]), len(PROMPTS[0]),
                            jcache)
    jtoks = np.stack([jfirst, np.asarray(jl2)[:, -1].argmax(-1)], 1).tolist()
    tl, cache = forward(params, cfg, torch.tensor(PROMPTS, dtype=torch.int32), 0,
                        KVCache.create(cfg, 2, T, device="cpu"))
    first = tl[:, -1].argmax(-1).to(torch.int32)
    tl2, _ = forward(params, cfg, first[:, None], len(PROMPTS[0]), cache)
    toks = torch.stack([first, tl2[:, -1].argmax(-1).to(torch.int32)], 1).tolist()
    return {"cfg": cfg, "params": params}, {
        "jax_tokens": jtoks, "tokens": toks, "jax_logits": [np.asarray(jl), np.asarray(jl2)],
        "logits": [tl, tl2]}


def test_four_processes_two_hosts_dp_tp_mesh(tmp_path):
    spec = dict(SPEC, vocab_size=512)
    jcfg = JModelArgs(**spec)
    jrandom = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(7))
    models, refs = {}, {}
    for name, jp in (("cyclic", cyclic_unfused(jrandom)), ("random", jrandom)):
        models[name], refs[name] = reference(jcfg, jp)
    cyc = [[CYCLE[(CYCLE.index(p[-1]) + i) % len(CYCLE)] for i in (1, 2)] for p in PROMPTS]
    assert refs["cyclic"]["jax_tokens"] == refs["cyclic"]["tokens"] == cyc
    payload = tmp_path / "payload.pt"
    torch.save({"models": models, "prompts": torch.tensor(PROMPTS, dtype=torch.int32),
                "T": T}, payload)
    env_base = {**os.environ, "LNB_COORD": f"127.0.0.1:{free_port()}", "LNB_NPROC": "4",
                "LNB_PAYLOAD": str(payload), "LNB_LIMIT_S": str(LIMIT_S),
                "OMP_NUM_THREADS": "1"}
    procs = []
    for pid in range(4):
        env = dict(env_base, LNB_PROC=str(pid), LNB_HOST=str(pid // 2),
                   LNB_OUT=str(tmp_path / f"proc{pid}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "from tests.tp_workers import multihost_main; "
             "multihost_main()"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LIMIT_S + 30)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0 and f"proc {pid}: done" in out, f"process {pid}:\n{out}"
    got = [torch.load(tmp_path / f"proc{pid}.pt", weights_only=False) for pid in range(4)]
    for pid, res in enumerate(got):
        # process p is host p // 2: a host is a dp row, its processes the tp pair
        assert res["coords"]["dp"] == (res["host"], 2) and res["coords"]["tp"] == (pid % 2, 2)
        assert res["cyclic"]["tokens"] == refs["cyclic"]["tokens"], pid
        assert res["random"]["tokens"] == refs["random"]["tokens"], pid
        row = res["host"]
        for step in range(2):
            mine = res["random"]["logits"][step]
            assert torch.equal(mine, got[2 * row + (1 - pid % 2)]["random"]["logits"][step])
            assert rel_l2(mine.numpy(), refs["random"]["logits"][step][row:row + 1].numpy()) \
                < REL_L2_SINGLE
            assert rel_l2(mine.numpy(), refs["random"]["jax_logits"][step][row:row + 1]) \
                < REL_L2_JAX
