"""LSTM layer: a generative character-level recurrent sequence model.

Port of ``deeplearning4j_tpu/nn/layers/lstm.py``
(``models/classifiers/lstm/LSTM.java:51``): ONE fused recurrent matrix,
so a step concatenates ``[x_t, h_{t-1}]`` and takes all four gates, in
the order i, f, o, g, from one product, then a softmax decoder.  The
product runs in ``conf.compute_dtype`` and is read back in fp32 before
the fp32 bias is added (reference :43-46); the cell state stays fp32.

The time loop is a plain Python loop over T of tensor ops (the reference
scans it with ``lax.scan`` in XLA, not in Pallas, so it has no hand
kernel).  ``torch.nn.LSTM`` is not used: its gate order (i, f, g, o) and
split input and hidden matrices would put a permutation between the two
packages' params.  ``truncate_bptt > 0`` means what it means in the
reference: each step is recomputed in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on the
scan body, :60), trading FLOPs for memory; the sequence is not cut.
Backprop is autograd.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import LayerKind
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@register_layer(LayerKind.LSTM)
class LSTMLayer(Layer):
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        return P.lstm_params(gen, self.conf, device)

    @property
    def hidden(self) -> int:
        return self.conf.hidden_size or self.conf.n_out

    def _cdt(self) -> torch.dtype:
        return getattr(torch, self.conf.compute_dtype)

    def _step(self, w: Tensor, b: Tensor, h_prev: Tensor, c_prev: Tensor,
              x_t: Tensor) -> Tuple[Tensor, Tensor]:
        """One step; ``w`` is ``recurrent_W`` already in the compute
        dtype, ``b`` the fp32 bias."""
        zx = torch.cat([x_t, h_prev], dim=-1)
        gates = (zx.to(w.dtype) @ w).float() + b
        i, f, o, g = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def scan_sequence(self, params: Params, xs: Tensor) -> Tensor:
        """xs ``[B, T, D]`` -> hidden states ``[B, T, H]``."""
        b = xs.shape[0]
        w = params["recurrent_W"].to(self._cdt())
        bias = params["recurrent_b"].float()
        h = torch.zeros((b, self.hidden), dtype=torch.float32,
                        device=xs.device)
        c = torch.zeros_like(h)
        remat = self.conf.truncate_bptt > 0 and torch.is_grad_enabled()
        hs = []
        for t in range(xs.shape[1]):
            if remat:
                h, c = checkpoint(self._step, w, bias, h, c, xs[:, t],
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, c = self._step(w, bias, h, c, xs[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1)

    def decode(self, params: Params, hs: Tensor) -> Tensor:
        """Hidden states -> output logits through the decoder."""
        cdt = self._cdt()
        return ((hs.to(cdt) @ params["decoder_W"].to(cdt)).float()
                + params["decoder_b"].float())

    def activate(self, params, x, gen=None, train=False):
        """``[B, T, D]`` -> ``[B, T, n_out]`` softmax sequence (the
        generative decode, LSTM.java:449-456); 2-D input is T = 1."""
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        logits = self.decode(params, self.scan_sequence(params, x))
        y = (torch.softmax(logits, dim=-1)
             if self.conf.activation == "softmax"
             else self.activation(logits))
        return y[:, 0, :] if squeeze else y

    def sequence_loss(self, params: Params, xs: Tensor, ys: Tensor
                      ) -> Tensor:
        """Next-step prediction loss over a sequence: the mean over
        batch and time of the cross-entropy against one-hot ``ys``."""
        logits = self.decode(params, self.scan_sequence(params, xs))
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.sum(ys * logp, dim=-1))

    def sample(self, params: Params, gen: torch.Generator, length: int,
               start_id: int = 0, temperature: float = 1.0) -> Tensor:
        """Autoregressive sampling of ``length`` ids (reference :92-115):
        each step's softmax decode picks the next one-hot input.  Needs
        one-hot io (``n_in == n_out``).  The draw is Gumbel-max over
        ``logits / temperature`` with uniforms from ``gen`` (the
        categorical draw the reference makes with its key; the two
        streams never agree, but near temperature 0 both take the
        argmax).  Returns ids ``[length]`` (int64) on the params'
        device."""
        vocab = self.conf.n_out
        if self.conf.n_in != vocab:
            raise ValueError(
                f"sampling needs one-hot io: n_in={self.conf.n_in} != "
                f"n_out={vocab}")
        dev = params["recurrent_W"].device
        w = params["recurrent_W"].to(self._cdt())
        bias = params["recurrent_b"].float()
        h = torch.zeros((1, self.hidden), dtype=torch.float32, device=dev)
        c = torch.zeros_like(h)
        x = torch.zeros((1, vocab), dtype=torch.float32, device=dev)
        x[0, start_id] = 1.0
        tiny = torch.finfo(torch.float32).tiny
        ids = []
        with torch.no_grad():
            for _ in range(length):
                h, c = self._step(w, bias, h, c, x)
                logits = self.decode(params, h)
                u = torch.rand(logits.shape, generator=gen, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp(tiny, 1.0)))
                nxt = torch.argmax(logits / temperature + gumbel, dim=-1)
                x = torch.nn.functional.one_hot(nxt, vocab).float()
                ids.append(nxt[0])
        return torch.stack(ids)
