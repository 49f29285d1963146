"""Recurrent layers and beam search of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/rnn.py``: the cells
(``SimpleRNNCell``, ``LSTMCell``, ``GRUCell`` on ``RNNCellBase``), ``RNN``
and ``BiRNN`` over a cell, the stacks ``SimpleRNN`` / ``LSTM`` / ``GRU``,
``BeamSearchDecoder`` and ``dynamic_decode``. Each cell step is one op of
the dispatch (``simple_rnn_cell``, ``lstm_cell``, ``gru_cell``), as in the
reference, so the amp casts and the census see the same names; a
sequence is a Python loop over time, one step per op (the reference's
docstring speaks of ``lax.scan``, but its loop is a Python loop too).
Weights are the reference's: ``weight_ih`` (gates x input), ``weight_hh``
(gates x hidden), ``bias_ih`` / ``bias_hh``, gates in the order i, f, g, o
(LSTM) and r, z, n (GRU), U(-1/sqrt(hidden), 1/sqrt(hidden)); a stack
names its cells ``cells.{layer * directions + direction}``, so
``nn.layer.load_numpy_state_dict`` carries the reference's weights
across. Layers take ``device`` (``cuda`` unless ``"cpu"`` is asked for)
and ``generator`` (the initial weights, and the stacks' dropout between
layers), keyword-only.

The reference's behaviour is kept where it departs from Paddle's (ROADMAP
Queue 3):

* ``sequence_length`` is accepted and never read by ``RNN``, ``BiRNN``
  and the stacks (``rnn.py:174``, ``:198``, ``:242``);
* ``SimpleRNN`` / ``LSTM`` / ``GRU`` take ``weight_ih_attr`` ... in
  ``**kw`` and drop them (``:283``, ``:291``, ``:298``): the cells get
  the default initializer;
* ``get_initial_states`` is float32 whatever the input's dtype (``:28``),
  so a bfloat16 input promotes to float32 at the first step (the cell's
  products promote as ``jnp`` does);
* ``BeamSearchDecoder.initialize`` makes int32 ids (``:335-336``);
* ``dynamic_decode`` runs up to ``max_step_num + 1`` steps (``while t <=
  max_step_num``, ``:399``), does not read ``impute_finished`` or
  ``is_test``, and returns the last step's states, which ``finalize`` does
  not reorder.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dtype import convert_dtype
from ...ops.dispatch import apply_op
from ...ops.manipulation import concat, stack
from .. import functional as F
from .. import initializer as init
from .layers import Layer, LayerList, create_parameter  # noqa: F401


def _linear(x, w, b):
    """x @ w.T + b, the operands promoted to one dtype first (as the
    reference's ``x @ wi.T + bi`` promotes)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return TF.linear(x.to(dt), w.to(dt), b.to(dt))


def _simple_rnn_cell(x, h, wi, wh, bi, bh, activation):
    pre = _linear(x, wi, bi) + _linear(h, wh, bh)
    return torch.tanh(pre) if activation == "tanh" else torch.relu(pre)


def _lstm_cell(x, h, c, wi, wh, bi, bh):
    gates = _linear(x, wi, bi) + _linear(h, wh, bh)
    i, f, g, o = gates.chunk(4, -1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_cell(x, h, wi, wh, bi, bh):
    ir, iz, in_ = _linear(x, wi, bi).chunk(3, -1)
    hr, hz, hn = _linear(h, wh, bh).chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1 - z) * n + z * h


class RNNCellBase(Layer):
    """Base of the cells: ``get_initial_states``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """(batch, hidden_size) filled with ``init_value``, float32 unless
        ``dtype`` is given, on ``batch_ref``'s device."""
        B = batch_ref.shape[batch_dim_idx]
        return torch.full((B, self.hidden_size), init_value,
                          dtype=convert_dtype(dtype or "float32"),
                          device=batch_ref.device)


class _Cell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = {"default_initializer": init.Uniform(-std, std),
              "device": device, "generator": generator}
        G = self.GATES * hidden_size
        self.weight_ih = create_parameter((G, input_size), weight_ih_attr,
                                          **kw)
        self.weight_hh = create_parameter((G, hidden_size), weight_hh_attr,
                                          **kw)
        self.bias_ih = create_parameter((G,), bias_ih_attr, is_bias=True,
                                        **kw)
        self.bias_hh = create_parameter((G,), bias_hh_attr, is_bias=True,
                                        **kw)

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(_Cell):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, generator=generator)
        self.activation = activation

    @property
    def state_shape(self):
        return ((self.hidden_size,),)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = apply_op("simple_rnn_cell", _simple_rnn_cell, inputs, states,
                     *self._weights(), activation=self.activation)
        return h, h


class LSTMCell(_Cell):
    """The LSTM step: gates i, f, g, o; returns (h', (h', c'))."""
    GATES = 4

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        h2, c2 = apply_op("lstm_cell", _lstm_cell, inputs, h, c,
                          *self._weights())
        return h2, (h2, c2)


class GRUCell(_Cell):
    """The GRU step: gates r, z, n; h' = (1 - z) n + z h."""
    GATES = 3

    @property
    def state_shape(self):
        return ((self.hidden_size,),)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        h2 = apply_op("gru_cell", _gru_cell, inputs, h, *self._weights())
        return h2, h2


def _step_input(x, t, time_axis):
    return x.select(time_axis, t)


def _run(cell, inputs, states, is_reverse, time_major):
    """The cell over the time axis of ``inputs``: (outputs stacked on that
    axis, the last states). Each step's input is the op ``getitem``, as
    the reference's indexing is."""
    time_axis = 0 if time_major else 1
    T = inputs.shape[time_axis]
    outputs = []
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        x_t = apply_op("getitem", _step_input, inputs, t=t,
                       time_axis=time_axis)
        out, states = cell(x_t, states)
        outputs.append(out)
    if is_reverse:
        outputs = outputs[::-1]
    return stack(outputs, axis=time_axis), states


class RNN(Layer):
    """A cell run over a sequence (batch-major unless ``time_major``);
    ``sequence_length`` is not read."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return _run(self.cell, inputs, initial_states, self.is_reverse,
                    self.time_major)


class BiRNN(Layer):
    """A forward and a reverse cell over one sequence; outputs
    concatenated on the last axis, states (forward, backward)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        o_fw, s_fw = self.rnn_fw(inputs, s_fw)
        o_bw, s_bw = self.rnn_bw(inputs, s_bw)
        return concat([o_fw, o_bw], axis=-1), (s_fw, s_bw)


class _RNNBase(Layer):
    """A stack of ``num_layers`` (bi)directional layers of one cell kind;
    dropout ``dropout`` on the outputs between layers in training."""

    MODE_CELLS = {"RNN_TANH": SimpleRNNCell, "RNN_RELU": SimpleRNNCell,
                  "LSTM": LSTMCell, "GRU": GRUCell}

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, *, device=None, generator=None):
        super().__init__()
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout = dropout
        self.generator = generator
        self.bidirect = direction in ("bidirect", "bidirectional")
        ndir = 2 if self.bidirect else 1
        self.state_components = 2 if mode == "LSTM" else 1
        kw = {"device": device, "generator": generator}
        cells = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * ndir
            for _ in range(ndir):
                if mode.startswith("RNN"):
                    cells.append(SimpleRNNCell(
                        in_sz, hidden_size, "tanh" if mode == "RNN_TANH"
                        else "relu", **kw))
                else:
                    cells.append(self.MODE_CELLS[mode](
                        in_sz, hidden_size, weight_ih_attr, weight_hh_attr,
                        bias_ih_attr, bias_hh_attr, **kw))
        self.cells = LayerList(cells)
        self._ndir = ndir

    def forward(self, inputs, initial_states=None, sequence_length=None):
        ndir, lstm = self._ndir, self.mode == "LSTM"
        x, final_h, final_c = inputs, [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(ndir):
                k = layer * ndir + d
                st = None
                if initial_states is not None:
                    st = ((initial_states[0][k], initial_states[1][k])
                          if lstm else initial_states[k])
                o, s = _run(self.cells[k], x, st, d == 1, self.time_major)
                outs.append(o)
                if lstm:
                    final_h.append(s[0])
                    final_c.append(s[1])
                else:
                    final_h.append(s)
            x = outs[0] if ndir == 1 else concat(outs, axis=-1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                x = F.dropout(x, p=self.dropout, training=self.training,
                              generator=self.generator)
        h_st = stack(final_h, axis=0)
        if lstm:
            return x, (h_st, stack(final_c, axis=0))
        return x, h_st


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, generator=None, **kw):
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU",
                         input_size, hidden_size, num_layers, direction,
                         time_major, dropout, device=device,
                         generator=generator)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, generator=None, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         generator=generator)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, generator=None, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         generator=generator)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _first_leaf(tree):
    return _first_leaf(tree[0]) if isinstance(tree, (tuple, list)) else tree


class BeamSearchDecoder:
    """A beam-expanded single-step decoder over an RNN cell, driven by
    ``dynamic_decode``: ``initialize`` tiles the cell states over the
    beams, ``step`` extends every live beam by every token and keeps the
    ``beam_size`` best sums of log-probabilities (a finished beam extends
    only by ``end_token``, at no cost), ``finalize`` walks the parents back
    (``F.gather_tree``)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(batch, ...) -> (batch * beam_size, ...), each row repeated."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def _merge(self, v):
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _split(self, v, batch):
        return v.reshape((batch, self.beam_size) + tuple(v.shape[1:]))

    def initialize(self, initial_cell_states):
        cs = _tree_map(lambda t: self.tile_beam_merge_with_batch(
            t, self.beam_size), initial_cell_states)
        ref = _first_leaf(initial_cell_states)
        batch, dev = ref.shape[0], ref.device
        ids = torch.full((batch, self.beam_size), self.start_token,
                         dtype=torch.int32, device=dev)
        # only beam 0 is live at first, so the copies do not tie
        log_probs = torch.tensor([0.0] + [-1e9] * (self.beam_size - 1),
                                 device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return ids, (cs, log_probs, finished)

    def step(self, time, inputs, states):
        cell_states, log_probs, finished = states
        batch = log_probs.shape[0]
        inp = self._merge(inputs.to(torch.int32))
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, next_states = self.cell(inp, cell_states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        vocab = out.shape[-1]
        step_lp = torch.log_softmax(out.float(), -1).reshape(
            batch, self.beam_size, vocab)
        mask = torch.full((vocab,), -1e9, device=out.device)
        mask[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], mask, step_lp)
        total = (log_probs[..., None] + step_lp).reshape(
            batch, self.beam_size * vocab)
        top_lp, top_idx = torch.topk(total, self.beam_size, -1)
        parent = (top_idx // vocab).to(torch.int32)
        token = (top_idx % vocab).to(torch.int32)
        new_finished = torch.gather(finished, 1, parent.long()) \
            | (token == self.end_token)

        def pick(v):
            s = self._split(v, batch)
            idx = parent.long().reshape(batch, self.beam_size,
                                        *([1] * (v.dim() - 1)))
            return self._merge(torch.take_along_dim(s, idx, 1))
        return (token, parent), (_tree_map(pick, next_states), top_lp,
                                 new_finished)

    def finalize(self, tokens, parents):
        """The sequences (time, batch, beam) from the per-step tokens and
        parents."""
        return F.gather_tree(torch.stack(tokens), torch.stack(parents))


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` from ``inits`` until every beam has finished or
    ``max_step_num + 1`` steps have run. Returns the sequences ((batch,
    time, beam), or (time, batch, beam) when ``output_time_major``), the
    last states and, with ``return_length``, each beam's length: the steps
    up to and including its first ``end_token`` (int32)."""
    ids, states = decoder.initialize(inits)
    tokens, parents = [], []
    inputs, t = ids, 0
    with torch.no_grad():
        while t <= int(max_step_num):
            (token, parent), states = decoder.step(t, inputs, states)
            tokens.append(token)
            parents.append(parent)
            inputs = token
            t += 1
            if bool(torch.all(states[2])):
                break
        seqs = decoder.finalize(tokens, parents)       # (T, batch, beam)
        is_end = seqs == decoder.end_token
        first_end = torch.argmax(is_end.to(torch.int32), 0) + 1
        lengths = torch.where(is_end.any(0), first_end,
                              seqs.shape[0]).to(torch.int32)
    if not output_time_major:
        seqs = seqs.movedim(0, 1)
    if return_length:
        return seqs, states, lengths
    return seqs, states
