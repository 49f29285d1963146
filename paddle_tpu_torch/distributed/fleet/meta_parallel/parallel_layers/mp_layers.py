"""The tensor (model) parallel layers of the PyTorch port.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/mp_layers.py``: ``VocabParallelEmbedding`` (``:30``),
``ColumnParallelLinear`` (``:97``), ``RowParallelLinear`` (``:170``) and
``ParallelCrossEntropy`` (``:249``). The reference's layers hold the full
logical weight annotated with a ``PartitionSpec``, and GSPMD inserts the
collectives. The port's follow Paddle's own design: each rank of the model
group holds its slice of the weight (columns for ``ColumnParallelLinear``,
rows for ``RowParallelLinear`` and for the embedding's vocabulary) and the
forward calls the collectives by hand (``collective.c_identity``,
``mp_allreduce``, ``c_concat``, ``c_split``):

* Column: identity forward, the input's gradient all-reduced; the output
  all-gathered with ``gather_output``;
* Row: the input split first unless ``input_is_parallel``; the product
  all-reduced; the bias added after;
* Embedding: the lookup of the rank's rows (ids outside them give zeros),
  all-reduced;
* cross entropy: the max, the sum of exponentials and the target's logit
  all-reduced, in float32.

Each parameter carries the reference's ``sharding_spec`` (a tuple of mesh
axis names or None), so ``param_shardings`` reads the same specs in both
packages, and ``is_distributed`` when it is a slice. A layer draws its
full weight from the default generator and keeps its slice, so layers
built from one seed at tp = 2 hold the slices of the tp = 1 layer. With no
hybrid group (or one model rank) they are ordinary full layers, as the
reference's are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .....nn.layer.layers import Layer, create_parameter
from .... import collective as C
from .... import topology as _topo


def _mp_group(mp_group=None):
    if mp_group is not None:
        return mp_group
    hcg = _topo.get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _slice(full, dim, group):
    """This rank's block of ``full`` along ``dim`` (all of it without a
    group of several ranks)."""
    if group is None or group.nranks <= 1:
        return full
    n = group.nranks
    if full.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(full.shape)} does not "
                         f"divide over {n} model-parallel ranks")
    return full.chunk(n, dim)[group.rank].contiguous()


def _param(full, dim, group, spec):
    data = full.detach() if dim is None else _slice(full.detach(), dim,
                                                    group)
    p = torch.nn.Parameter(data, requires_grad=full.requires_grad)
    p.sharding_spec = spec
    p.is_distributed = dim is not None and group is not None \
        and group.nranks > 1
    return p


class VocabParallelEmbedding(Layer):
    """The (num_embeddings, embedding_dim) table, its vocabulary rows
    split over the model group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        from .....nn import initializer as init
        self.group = _mp_group(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        full = create_parameter((num_embeddings, embedding_dim), weight_attr,
                                default_initializer=init.XavierNormal(),
                                dtype=self._dtype)
        self.weight = _param(full, 0, self.group, ("model", None))
        n = 1 if self.group is None else self.group.nranks
        self.vocab_start = (0 if n == 1 else self.group.rank
                            * (num_embeddings // n))

    def forward(self, x):
        if self.group is None or self.group.nranks <= 1:
            return F.embedding(x, self.weight)
        return vocab_parallel_embedding(x, self.weight, self.vocab_start,
                                        self.group)


def vocab_parallel_embedding(ids, weight, start, group):
    """The rows of ``ids`` from a table holding rows ``start`` ..
    ``start + len(weight)`` of the vocabulary on each rank of ``group``:
    the local lookup, zeros for ids outside it, summed over the group."""
    rows = weight.shape[0]
    outside = (ids < start) | (ids >= start + rows)
    local = torch.where(outside, torch.zeros_like(ids), ids - start)
    out = F.embedding(local, weight)
    out = out.masked_fill(outside[..., None], 0)
    return C.mp_allreduce(out, group)


class ColumnParallelLinear(Layer):
    """x @ W (in, out) + b with W's columns (and b) split over the model
    group; ``gather_output`` gathers the output's columns."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        from .....nn import initializer as init
        self.group = _mp_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        full = create_parameter((in_features, out_features), weight_attr,
                                default_initializer=init.XavierNormal(),
                                dtype=self._dtype)
        self.weight = _param(full, 1, self.group, (None, "model"))
        if has_bias is False:
            self.bias = None
        else:
            b = create_parameter((out_features,), is_bias=True,
                                 dtype=self._dtype)
            self.bias = _param(b, 0, self.group, ("model",))

    def forward(self, x):
        parallel = self.group is not None and self.group.nranks > 1
        if parallel:
            x = C.c_identity(x, self.group)
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        if parallel and self.gather_output:
            out = C.c_concat(out, self.group)
        return out


class RowParallelLinear(Layer):
    """x @ W (in, out) + b with W's rows split over the model group; the
    input split first unless ``input_is_parallel``; the product summed
    over the group, then the (replicated) bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        from .....nn import initializer as init
        self.group = _mp_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        full = create_parameter((in_features, out_features), weight_attr,
                                default_initializer=init.XavierNormal(),
                                dtype=self._dtype)
        self.weight = _param(full, 0, self.group, ("model", None))
        if has_bias:
            b = create_parameter((out_features,), is_bias=True,
                                 dtype=self._dtype)
            self.bias = _param(b, None, self.group, None)
        else:
            self.bias = None

    def forward(self, x):
        parallel = self.group is not None and self.group.nranks > 1
        if parallel and not self.input_is_parallel:
            x = C.c_split(x, self.group)
        out = torch.matmul(x, self.weight)
        if parallel:
            out = C.mp_allreduce(out, self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


class _ParallelCE(torch.autograd.Function):
    """Per-row CE of logits whose last dimension (the vocabulary) is split
    over ``group``, in float32: the max, the sum of exponentials and the
    target's logit all-reduced. The backward recomputes the softmax from
    the saved logits: (softmax - onehot) * g, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, label, group, start, ignore_index):
        x = logits.float()
        m = x.amax(-1)
        C.all_reduce(m, op=C.ReduceOp.MAX, group=group)
        s = torch.exp(x - m[..., None]).sum(-1)
        C.all_reduce(s, group=group)
        V = x.shape[-1]
        inside = (label >= start) & (label < start + V)
        local = torch.where(inside, label - start, torch.zeros_like(label))
        tgt = torch.where(inside, x.gather(-1, local[..., None])[..., 0],
                          torch.zeros_like(m))
        C.all_reduce(tgt, group=group)
        keep = label != ignore_index
        loss = torch.where(keep, torch.log(s) + m - tgt, torch.zeros_like(m))
        ctx.save_for_backward(logits, m, s, local, inside & keep, keep)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, m, s, local, hit, keep = ctx.saved_tensors
        grad = torch.exp(logits.float() - m[..., None]) / s[..., None]
        grad.scatter_add_(-1, local[..., None],
                          -hit.to(grad.dtype)[..., None])
        grad = grad * (g * keep)[..., None]
        return grad.to(logits.dtype), None, None, None, None


def parallel_cross_entropy(logits, label, group, start, ignore_index=-100):
    """Per-row CE (float32) of vocabulary-split logits (this rank's
    columns ``start`` .. ``start + logits.shape[-1]``) against the global
    ``label`` ids; 0 where ``label == ignore_index``."""
    return _ParallelCE.apply(logits, label.long(), group, start,
                             ignore_index)


class ParallelCrossEntropy(Layer):
    """CE of logits whose classes are split over the model group
    (``c_softmax_with_cross_entropy``): (N, 1) float32 losses, 0 at
    ``ignore_index``. With one model rank, ``F.cross_entropy``'s."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        if self.group is None or self.group.nranks <= 1:
            from .....nn import functional as PF
            loss = PF.cross_entropy(input, label, reduction="none",
                                    ignore_index=self.ignore_index)
            return loss.reshape(label.shape).unsqueeze(-1)
        start = self.group.rank * input.shape[-1]
        return parallel_cross_entropy(input, label, self.group, start,
                                      self.ignore_index).unsqueeze(-1)
