"""Class-sharded margin-softmax classifier, PartialFC (reference:
third_part/face3d/models/arcface_torch/partial_fc.py:11-222;
s2v_tpu/parallel/partial_fc.py).

The [num_classes, emb] weight is split by class over the ranks of a model
group; each rank holds rows [shard * c_shard, (shard + 1) * c_shard). Every
rank sees the whole batch's L2-normalised features and labels, computes its
shard's logits and margin, and the softmax is made global with all-reduces
where the reference placed them (:188-195):

- the row max, a constant to the gradient: ``dist.all_reduce`` MAX on a
  detached tensor;
- the sum of exponentials and the target logit: SUMs through
  ``torch.distributed.nn.functional.all_reduce``, whose backward is itself an
  all-reduce.

The loss is the same on every rank of the group. Each rank's copy counts once
in the all-reduces' backward, so a rank differentiates ``loss / group size``:
the weight shard's gradient is then exact, and the features' gradient is this
shard's part, which a SUM over the group completes (the reference's
reduce-scatter of feature gradients, :216-219, which JAX's AD derives from
the psum). ``make_sharded_classifier`` and the ArcFace trainer do both.

Negative sampling (PartialFC 0.1, :100-123): every shard keeps its positive
classes and fills up to ``int(sample_rate * c_shard)`` rows with random
negatives, the positives scored 2.0 over uniform [0, 1) draws and the top
``num_sample`` kept (:112-114). The draws come from a ``torch.Generator``
seeded from the trainer's seed, the step and the shard index
(``sampling_generator``); they cannot match JAX's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def margin_logits(logits: torch.Tensor, onehot: torch.Tensor, margin_kind: str,
                  s: float, m: float) -> torch.Tensor:
    """The ArcFace (cos(theta + m)) or CosFace (cos - m) margin on the
    target class's cosine, times the scale ``s``; "none" scales only."""
    if margin_kind == "none":
        return logits * s
    if margin_kind == "cosface":
        return s * (logits - onehot * m)
    if margin_kind == "arcface":
        cos = logits.clamp(-1.0 + 1e-7, 1.0 - 1e-7)
        return s * torch.where(onehot > 0, torch.cos(torch.arccos(cos) + m), cos)
    raise ValueError(margin_kind)


def sampling_generator(seed: int, step: int, shard: int) -> torch.Generator:
    """The CPU generator of one step's negative draws on one shard."""
    state = np.random.SeedSequence([int(seed), int(step), int(shard)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def sample_classes(local_label: torch.Tensor, in_shard: torch.Tensor, c_shard: int,
                   num_sample: int, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PartialFC negative sampling (partial_fc.py:100-123). Returns (index
    [num_sample], the sorted selected rows of the shard, every positive
    among them; remapped [B], each in-shard label's position in ``index``)."""
    dev = local_label.device
    score = torch.rand(c_shard, generator=generator).to(dev)
    score[local_label[in_shard]] = 2.0
    index = torch.sort(torch.topk(score, num_sample).indices).values
    remapped = torch.searchsorted(index, local_label.contiguous()).clamp(max=num_sample - 1)
    return index, remapped


def partial_fc_loss(features: torch.Tensor, labels: torch.Tensor, weight_shard: torch.Tensor,
                    group=None, margin_kind: str = "arcface", s: float = 64.0, m: float = 0.5,
                    sample_rate: float = 1.0, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Mean margin cross-entropy of ``features`` [B, E] (L2-normalised, the
    whole batch) against ``labels`` [B] (global class ids), with this rank's
    class shard ``weight_shard`` [C / group size, E]. Differentiable in the
    features and the shard. ``sample_rate < 1`` samples negatives from
    ``generator`` (``sampling_generator`` of this shard). Without a group,
    the whole classifier on one device."""
    shard = 0 if group is None else dist.get_rank(group)
    c_shard = weight_shard.shape[0]
    local = labels.long() - shard * c_shard
    in_shard = (local >= 0) & (local < c_shard)
    local = torch.where(in_shard, local, torch.zeros_like(local))
    w = weight_shard
    if sample_rate < 1.0:
        if generator is None:
            raise ValueError("sample_rate < 1 needs a generator")
        index, local = sample_classes(local, in_shard, c_shard,
                                      max(int(sample_rate * c_shard), 1), generator)
        w = weight_shard[index]  # the gradient scatters back into the sampled rows
    wn = w * torch.rsqrt(w.square().sum(1, keepdim=True) + 1e-12)
    logits = features @ wn.t()  # [B, n] cosine similarities
    onehot = torch.zeros_like(logits)
    rows = torch.nonzero(in_shard).flatten()
    onehot[rows, local[rows]] = 1.0
    logits = margin_logits(logits, onehot, margin_kind, s, m)
    row_max = logits.detach().max(1).values
    if group is not None:
        dist.all_reduce(row_max, op=dist.ReduceOp.MAX, group=group)
    logits = logits - row_max[:, None]
    denom = logits.exp().sum(1)
    target = (logits * onehot).sum(1)
    if group is not None:
        from torch.distributed.nn.functional import all_reduce

        denom, target = all_reduce(denom, group=group), all_reduce(target, group=group)
    return (torch.log(denom) - target).mean()


def shard_rows(weight: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's class shard of a whole [C, E] classifier weight."""
    if group is None:
        return weight
    n = dist.get_world_size(group)
    if weight.shape[0] % n:
        raise ValueError(f"{weight.shape[0]} classes do not split over {n} shards")
    return weight.chunk(n)[dist.get_rank(group)]


def make_sharded_classifier(group=None, margin_kind: str = "arcface", s: float = 64.0,
                            m: float = 0.5):
    """Returns (loss_fn, grad_fn) over a class-sharded classifier:
    ``loss_fn(features, labels, weight_shard)`` -> the loss, and
    ``grad_fn(features, labels, weight_shard)`` -> (the features' gradient,
    whole on every rank; this shard's weight gradient)."""

    def loss_fn(features, labels, weight_shard):
        return partial_fc_loss(features, labels, weight_shard, group, margin_kind, s, m)

    def grad_fn(features, labels, weight_shard):
        f = features.detach().requires_grad_(True)
        w = weight_shard.detach().requires_grad_(True)
        n = 1 if group is None else dist.get_world_size(group)
        gf, gw = torch.autograd.grad(loss_fn(f, labels, w) / n, (f, w))
        if group is not None:
            dist.all_reduce(gf, group=group)
        return gf, gw

    return loss_fn, grad_fn
