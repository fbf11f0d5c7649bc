"""LSTM language models, counterparts of ``mxnet_tpu/models/lstm.py``
with the same node and parameter names in the same order:

* :func:`lstm_unroll` — one symbol a time step over shared weight
  variables, for the bucketing module;
* :func:`lstm_fused` — the fused ``RNN`` op, cuDNN's RNN on a card.
"""
from .. import symbol as sym

__all__ = ["lstm_unroll", "lstm_fused"]


def _lstm_cell(num_hidden, indata, prev_h, prev_c, param, seqidx, layeridx):
    """One LSTM step from shared weights."""
    i2h = sym.FullyConnected(data=indata, weight=param["i2h_weight"],
                             bias=param["i2h_bias"],
                             num_hidden=num_hidden * 4,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_h, weight=param["h2h_weight"],
                             bias=param["h2h_bias"],
                             num_hidden=num_hidden * 4,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    gates = i2h + h2h
    slices = sym.SliceChannel(data=gates, num_outputs=4, axis=1,
                              name="t%d_l%d_slice" % (seqidx, layeridx))
    in_gate = sym.Activation(slices[0], act_type="sigmoid")
    forget_gate = sym.Activation(slices[1], act_type="sigmoid")
    in_transform = sym.Activation(slices[2], act_type="tanh")
    out_gate = sym.Activation(slices[3], act_type="sigmoid")
    next_c = (forget_gate * prev_c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return next_h, next_c


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0):
    """An LSTM LM unrolled over a (batch, seq_len) sequence of ids: the
    initial states ``l<i>_init_h``/``l<i>_init_c`` are arguments, the
    labels go time-major through ``transpose`` and ``Reshape`` to match
    the order of the concatenated steps."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    params = []
    init_states = []
    for i in range(num_lstm_layer):
        params.append({
            "i2h_weight": sym.Variable("l%d_i2h_weight" % i),
            "i2h_bias": sym.Variable("l%d_i2h_bias" % i),
            "h2h_weight": sym.Variable("l%d_h2h_weight" % i),
            "h2h_bias": sym.Variable("l%d_h2h_bias" % i),
        })
        init_states.append((sym.Variable("l%d_init_h" % i),
                            sym.Variable("l%d_init_c" % i)))

    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=input_size,
                          weight=embed_weight, output_dim=num_embed,
                          name="embed")
    wordvec = sym.SliceChannel(data=embed, num_outputs=seq_len, axis=1,
                               squeeze_axis=True, name="wordvec_slice")

    hidden_all = []
    states = list(init_states)
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_lstm_layer):
            next_h, next_c = _lstm_cell(num_hidden, hidden, states[i][0],
                                        states[i][1], params[i], seqidx, i)
            states[i] = (next_h, next_c)
            hidden = next_h
        if dropout > 0:
            hidden = sym.Dropout(data=hidden, p=dropout)
        hidden_all.append(hidden)

    hidden_concat = sym.Concat(*hidden_all, num_args=seq_len, dim=0)
    pred = sym.FullyConnected(data=hidden_concat, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias, name="pred")
    label_t = sym.transpose(data=label)
    label_flat = sym.Reshape(data=label_t, target_shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")


def lstm_fused(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0):
    """The same LM through the fused RNN op (mode lstm): its
    ``lstm_parameters``, ``lstm_state`` and ``lstm_state_cell`` are
    arguments."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=input_size,
                          output_dim=num_embed, name="embed")
    tnc = sym.SwapAxis(data=embed, dim1=0, dim2=1)
    rnn = sym.RNN(data=tnc, state_size=num_hidden,
                  num_layers=num_lstm_layer, mode="lstm", p=dropout,
                  name="lstm")
    flat = sym.Reshape(data=rnn, target_shape=(-1, num_hidden))
    pred = sym.FullyConnected(data=flat, num_hidden=num_label, name="pred")
    label_t = sym.transpose(data=label)
    label_flat = sym.Reshape(data=label_t, target_shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")
