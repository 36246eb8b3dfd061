"""Progressive neural network primitives and the MCP composer (PHC's
teacher).

Counterpart of `pulse_tpu/learning/pnn.py`:
  * `PNN`: N parallel MLP columns, each mapping the observation to an
    action, optionally with the reference's lateral connections (layer li
    of column c receives a bias-free map of layer li-1's activation of
    every earlier column; not the first hidden layer, not the output);
    with `column_inputs` each column reads its own observation row
    [..., N, obs]. Returns every column's action [..., N, A]. Without
    laterals the columns run as one batched GEMM a layer over stacked
    [N, in, out] weights. The columns compute in float32 with autocast
    off, whatever the caller's (the flax PNN has no compute dtype);
  * `MCPComposer`: an MLP to weights over the primitives (softmax, or a
    plain activation as the reference's distillation teacher rebuilds it);
  * `compose_actions`: the weighted blend sum_i w_i prim_i.
`pnn_from_jax` and `mcp_composer_from_jax` load flax param trees.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.learning.networks import _ACT, _TRUNC_STD, MLP, _dense_leaves, _flax_init_, _linears, _tower


class PNN(nn.Module):
    """forward(x [..., in] or [..., N, in]) -> [..., N, A]. The weights of
    hidden layer li are `weight[li]` [N, in, out] and `bias[li]` [N, out]
    (flax's [in, out] kernel layout), the output layer's `out_weight`
    [N, units[-1], A] and `out_bias` [N, A], and the lateral map from
    column pc to column c at layer li `lateral[f"lat{pc}to{c}_l{li}"]`
    [units[li-1], units[li]]. Initialization is flax Dense's (lecun normal,
    zero biases), drawn from `seed`."""

    def __init__(self, in_dim: int, action_dim: int, num_primitives: int = 3, units: Sequence[int] = (1024, 512),
                 activation: str = "silu", has_lateral: bool = False, column_inputs: bool = False, device=None,
                 seed: int = 0):
        super().__init__()
        self.in_dim, self.action_dim, self.num_primitives = in_dim, action_dim, num_primitives
        self.units, self.activation = tuple(units), activation
        self.has_lateral, self.column_inputs = has_lateral, column_inputs
        self.act = _ACT[activation]()
        N, widths = num_primitives, [in_dim, *units]
        self.weight = nn.ParameterList([nn.Parameter(torch.empty(N, i, o)) for i, o in zip(widths[:-1], widths[1:])])
        self.bias = nn.ParameterList([nn.Parameter(torch.zeros(N, o)) for o in units])
        self.out_weight = nn.Parameter(torch.empty(N, widths[-1], action_dim))
        self.out_bias = nn.Parameter(torch.zeros(N, action_dim))
        self.lateral = nn.ParameterDict({
            f"lat{pc}to{c}_l{li}": nn.Parameter(torch.empty(units[li - 1], units[li]))
            for c in range(1, N) for li in range(1, len(units)) for pc in range(c)} if has_lateral else {})
        g = torch.Generator().manual_seed(seed)
        for w in [*self.weight, self.out_weight, *self.lateral.values()]:
            for k in range(w.shape[0] if w.dim() == 3 else 1):
                m = w[k] if w.dim() == 3 else w
                std = math.sqrt(1.0 / m.shape[0]) / _TRUNC_STD
                nn.init.trunc_normal_(m.data, std=std, a=-2 * std, b=2 * std, generator=g)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            if self.has_lateral:
                return self._columns(x)
            h = x
            for li, (w, b) in enumerate(zip(self.weight, self.bias)):
                if li == 0 and not self.column_inputs:
                    h = torch.einsum("...i,nio->...no", h, w) + b
                else:
                    h = torch.einsum("...ni,nio->...no", h, w) + b
                h = self.act(h)
            return torch.einsum("...ni,nia->...na", h, self.out_weight) + self.out_bias

    def _columns(self, x: torch.Tensor) -> torch.Tensor:
        """Column by column, with the lateral connections if any."""
        outs, acts = [], []
        for c in range(self.num_primitives):
            h = x[..., c, :] if self.column_inputs else x
            acts_c = []
            for li, (w, b) in enumerate(zip(self.weight, self.bias)):
                h = h @ w[c] + b[c]
                if self.has_lateral and c > 0 and li > 0:
                    for pc in range(c):
                        h = h + acts[pc][li - 1] @ self.lateral[f"lat{pc}to{c}_l{li}"]
                h = self.act(h)
                acts_c.append(h)
            acts.append(acts_c)
            outs.append(h @ self.out_weight[c] + self.out_bias[c])
        return torch.stack(outs, dim=-2)


class MCPComposer(nn.Module):
    """obs -> weights over the primitives: an MLP, one linear layer of
    num_primitives logits, then softmax (`final="softmax"`, the trained MCP
    policy's head) or the named activation (the reference's distillation
    teacher, rebuilt from its state dict without the softmax)."""

    def __init__(self, in_dim: int, num_primitives: int = 3, units: Sequence[int] = (512, 256),
                 activation: str = "relu", final: str = "softmax", device=None, seed: int = 0):
        super().__init__()
        self.trunk = MLP(in_dim, units, activation)
        self.logits = nn.Linear(units[-1], num_primitives)
        self.final_act = None if final == "softmax" else _ACT[final]()
        _flax_init_(self, seed)
        self.to(resolve_device(device))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        logits = self.logits(self.trunk(obs))
        return torch.softmax(logits, dim=-1) if self.final_act is None else self.final_act(logits)


def compose_actions(weights: torch.Tensor, primitive_actions: torch.Tensor) -> torch.Tensor:
    """weights [..., N], primitive actions [..., N, A] -> [..., A]."""
    return torch.einsum("...n,...na->...a", weights, primitive_actions)


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def pnn_from_jax(params: dict, activation: str = "silu", column_inputs: bool = False, device=None) -> PNN:
    """A PNN holding a flax PNN's param tree (numpy leaves: `col{c}_dense{li}`,
    `lat{pc}to{c}_l{li}`, `col{c}_out`); its widths and laterals read from
    the tree."""
    N = sum(k.endswith("_out") for k in params)
    L = sum(k.startswith("col0_dense") for k in params)
    k0 = np.asarray(params["col0_dense0"]["kernel"])
    units = [np.asarray(params[f"col0_dense{li}"]["kernel"]).shape[1] for li in range(L)]
    net = PNN(k0.shape[0], np.asarray(params["col0_out"]["kernel"]).shape[1], N, units, activation,
              has_lateral=any(k.startswith("lat") for k in params), column_inputs=column_inputs, device="cpu")
    with torch.no_grad():
        for li in range(L):
            net.weight[li].copy_(torch.stack([_t(params[f"col{c}_dense{li}"]["kernel"]) for c in range(N)]))
            net.bias[li].copy_(torch.stack([_t(params[f"col{c}_dense{li}"]["bias"]) for c in range(N)]))
        net.out_weight.copy_(torch.stack([_t(params[f"col{c}_out"]["kernel"]) for c in range(N)]))
        net.out_bias.copy_(torch.stack([_t(params[f"col{c}_out"]["bias"]) for c in range(N)]))
        for name, p in net.lateral.items():
            p.copy_(_t(params[name]["kernel"]))
    return net.to(resolve_device(device))


def mcp_composer_from_jax(params: dict, activation: str = "relu", final: str = "softmax",
                          device=None) -> MCPComposer:
    """An MCPComposer holding a flax MCPComposer's param tree (numpy
    leaves: `MLP_0` trunk, `Dense_0` logits)."""
    trunk = _tower(params["MLP_0"])
    net = MCPComposer(np.asarray(trunk[0]["kernel"]).shape[0], np.asarray(params["Dense_0"]["kernel"]).shape[1],
                      [np.asarray(d["kernel"]).shape[1] for d in trunk], activation, final, device="cpu")
    with torch.no_grad():
        for t, x in _dense_leaves(zip(_linears(net.trunk) + [net.logits], trunk + [params["Dense_0"]])):
            t.copy_(x)
    return net.to(resolve_device(device))
