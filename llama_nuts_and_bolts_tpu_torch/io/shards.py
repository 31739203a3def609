"""Meta's model-parallel checkpoints: ``consolidated.00.pth`` .. ``NN.pth``.

Port of the sharded half of ``llama_nuts_and_bolts_tpu/io/torch_ckpt.py``
(70B ships as eight shards). Each shard is read with PyTorch's own ingest,
``torch.load(path, mmap=True, weights_only=True, map_location="cpu")``.
Column-parallel weights concatenate along dim 0, row-parallel ones along
dim 1, the token embedding along the embedding dim; norms are replicated,
and a replicated tensor is taken from shard 0. A tensor is concatenated only
when it is read (:meth:`ShardedTensor.materialize`), one at a time, so host
memory holds one combined tensor beyond the memory maps.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_SHARD_AXIS_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    ("tok_embeddings.weight", 1),
    ("output.weight", 0),
    (".attention.wq.weight", 0),
    (".attention.wk.weight", 0),
    (".attention.wv.weight", 0),
    (".attention.wo.weight", 1),
    (".feed_forward.w1.weight", 0),
    (".feed_forward.w3.weight", 0),
    (".feed_forward.w2.weight", 1),
    ("norm.weight", None),          # replicated (attention_norm/ffn_norm/norm)
    ("rope.freqs", None),
)


def shard_concat_axis(name: str) -> Optional[int]:
    """The axis along which the shards of tensor ``name`` concatenate, or
    None for a replicated tensor."""
    for suffix, axis in _SHARD_AXIS_RULES:
        if name.endswith(suffix) or name == suffix:
            return axis
    return None


def find_checkpoint_shards(model_dir: str) -> List[str]:
    """``consolidated.NN.pth`` files in ``model_dir``, in shard order; a name
    whose middle part is not all digits (``consolidated.bak.pth``) is no
    shard."""
    paths = sorted(glob.glob(os.path.join(model_dir, "consolidated.*.pth")))
    return [p for p in paths if os.path.basename(p).split(".")[1].isdigit()]


@dataclass
class ShardedTensor:
    """One checkpoint tensor split across shards, concatenated when read."""

    name: str
    shards: List[torch.Tensor]
    axis: Optional[int]

    @property
    def shape(self) -> Tuple[int, ...]:
        base = list(self.shards[0].shape)
        if self.axis is not None:
            base[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return tuple(base)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def materialize(self) -> torch.Tensor:
        """The combined tensor: one host copy of this tensor only."""
        if self.axis is None or len(self.shards) == 1:
            return self.shards[0]
        return torch.cat(self.shards, dim=self.axis)


def load_sharded_checkpoint(paths: Sequence[str]) -> Dict[str, ShardedTensor]:
    """Open every shard (memory-mapped) and pair up its tensors by name, in
    the order of ``paths``; nothing is concatenated yet."""
    per_shard = [torch.load(p, mmap=True, weights_only=True, map_location="cpu")
                 for p in paths]
    return {name: ShardedTensor(name=name,
                                shards=[s[name] for s in per_shard if name in s],
                                axis=shard_concat_axis(name))
            for name in per_shard[0]}
