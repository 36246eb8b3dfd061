"""Importers of the reference's `.pth` checkpoints (PHC and PULSE).

Counterpart of the `.pth` half of `pulse_tpu/utils/checkpoint.py`: a
reference checkpoint holds a "model" dict whose keys the rl-games builders
named (`a2c_network.z_mlp.*`, `.z_mu`, `.z_logvar`, `.z_prior*`,
`.actor_mlp`, `.mu`, `.critic_mlp`, `.value`, `.sigma`,
`a2c_network.pnn.actors.{c}.{i}`, `a2c_network.pnn.u.{c-1}.{pc}.{k}`,
`a2c_network.composer.*`, `running_mean_std.*`). Each importer builds the
port's own module at the checkpoint's widths on the requested device and
copies the weights in. A reference Sequential interleaves activations, so
its Linear layers sit at even indices, as in the port's `MLP`; a torch
Linear's [out, in] weight goes into a torch Linear as it is, and is
transposed only into the PNN's stacked [N, in, out] weights.

The port's own checkpoints (`run.py`'s `epoch_N.pt`) are another format;
`is_reference_checkpoint` tells the two apart by content.
"""

from __future__ import annotations

import pickle
import re

import torch
from torch import nn

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.learning.networks import MLP, Decoder, Encoder, Prior, PulseVAE, _linears
from pulse_tpu_torch.learning.pnn import PNN, MCPComposer
from pulse_tpu_torch.learning.running_norm import RunningMeanStd


def load_torch_checkpoint(path: str) -> dict:
    """A reference checkpoint read on the CPU: its entries, with "model" a
    dict of CPU tensors. A file of tensors and plain data is read with
    `weights_only`; one that holds more (an rl-games file may) has its
    whole pickle loaded, which is printed: read only files you trust."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        print(f"{path}: holds more than tensors and plain data; its whole pickle was loaded")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = dict(ckpt)
    out["model"] = {k: torch.as_tensor(v) for k, v in ckpt.get("model", {}).items()}
    return out


def is_reference_checkpoint(ckpt) -> bool:
    """A reference checkpoint's contents: a "model" dict of `a2c_network.*`
    keys (the port's own hold "network")."""
    model = ckpt.get("model") if isinstance(ckpt, dict) else None
    return isinstance(model, dict) and any(str(k).startswith("a2c_network.") for k in model)


def _stack(sd: dict, prefix: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(weight [out, in], bias) of each Linear of a reference Sequential, in
    order."""
    idxs = sorted(int(m.group(1)) for k in sd if (m := re.fullmatch(re.escape(prefix) + r"\.(\d+)\.weight", k)))
    if not idxs:
        raise KeyError(f"no Linear layers under {prefix!r}")
    return [(torch.as_tensor(sd[f"{prefix}.{i}.weight"]), torch.as_tensor(sd[f"{prefix}.{i}.bias"])) for i in idxs]


def _pair(sd: dict, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.as_tensor(sd[f"{name}.weight"]), torch.as_tensor(sd[f"{name}.bias"])


@torch.no_grad()
def _copy(linears: list, pairs: list) -> None:
    if len(linears) != len(pairs):
        raise ValueError(f"{len(pairs)} Linear layers for {len(linears)}")
    for lin, (w, b) in zip(linears, pairs):
        if lin.weight.shape != w.shape:
            raise ValueError(f"weight {tuple(w.shape)} for a Linear of {tuple(lin.weight.shape)}")
        lin.weight.copy_(w)
        lin.bias.copy_(b)


def _units(pairs) -> list[int]:
    return [int(w.shape[0]) for w, _ in pairs]


def _encoder_prefix(sd: dict) -> str:
    return "a2c_network._task_mlp" if "a2c_network._task_mlp.0.weight" in sd else "a2c_network.z_mlp"


def import_z_encoder(sd: dict, activation: str = "silu", device=None) -> Encoder:
    """`a2c_network.z_mlp` (its last Linear the unactivated 5 x latent
    bottleneck, the Encoder's `z_proj`), `.z_mu`, `.z_logvar` -> Encoder."""
    *trunk, z_proj = _stack(sd, _encoder_prefix(sd))
    mu, logvar = _pair(sd, "a2c_network.z_mu"), _pair(sd, "a2c_network.z_logvar")
    latent = int(mu[0].shape[0])
    enc = Encoder(int(trunk[0][0].shape[1]), latent, _units(trunk), activation)
    _copy(_linears(enc.trunk) + [enc.z_proj, enc.z_mu, enc.z_logvar], trunk + [z_proj, mu, logvar])
    return enc.to(resolve_device(device))


def import_z_prior(sd: dict, activation: str = "silu", device=None) -> Prior:
    """`a2c_network.z_prior`, `.z_prior_mu`, `.z_prior_logvar` -> Prior."""
    trunk = _stack(sd, "a2c_network.z_prior")
    mu, logvar = _pair(sd, "a2c_network.z_prior_mu"), _pair(sd, "a2c_network.z_prior_logvar")
    prior = Prior(int(trunk[0][0].shape[1]), int(mu[0].shape[0]), _units(trunk), activation)
    _copy(_linears(prior.trunk) + [prior.mu, prior.logvar], trunk + [mu, logvar])
    return prior.to(resolve_device(device))


def import_z_decoder(sd: dict, activation: str = "silu", latent_dim: int | None = None, device=None) -> Decoder:
    """`a2c_network.actor_mlp` + `.mu` -> Decoder of [self obs, z]; the
    latent width is `.z_mu`'s unless given."""
    trunk, out = _stack(sd, "a2c_network.actor_mlp"), _pair(sd, "a2c_network.mu")
    latent = latent_dim if latent_dim is not None else int(torch.as_tensor(sd["a2c_network.z_mu.weight"]).shape[0])
    dec = Decoder(int(trunk[0][0].shape[1]) - latent, latent, int(out[0].shape[0]), _units(trunk), activation)
    _copy(_linears(dec.trunk) + [dec.out], trunk + [out])
    return dec.to(resolve_device(device))


def import_critic(sd: dict, activation: str = "silu", device=None) -> tuple[MLP, nn.Linear]:
    """`a2c_network.critic_mlp` + `.value` -> (trunk, head)."""
    trunk, value = _stack(sd, "a2c_network.critic_mlp"), _pair(sd, "a2c_network.value")
    mlp, head = MLP(int(trunk[0][0].shape[1]), _units(trunk), activation), nn.Linear(int(value[0].shape[1]), 1)
    _copy(_linears(mlp) + [head], trunk + [value])
    dev = resolve_device(device)
    return mlp.to(dev), head.to(dev)


def pulse_vae_spec_from_torch(sd: dict) -> dict:
    """The PulseVAE constructor's widths from a reference checkpoint's
    weight shapes (the z_mlp's last Linear is the bottleneck, not a unit)."""
    latent = int(torch.as_tensor(sd["a2c_network.z_mu.weight"]).shape[0])
    enc = _stack(sd, _encoder_prefix(sd))
    return {
        "obs_dim": int(enc[0][0].shape[1]),
        "action_dim": int(torch.as_tensor(sd["a2c_network.mu.weight"]).shape[0]),
        "latent_dim": latent,
        "self_obs_dim": int(torch.as_tensor(sd["a2c_network.actor_mlp.0.weight"]).shape[1]) - latent,
        "encoder_units": tuple(_units(enc)[:-1]),
        "prior_units": tuple(_units(_stack(sd, "a2c_network.z_prior"))),
        "decoder_units": tuple(_units(_stack(sd, "a2c_network.actor_mlp"))),
        "critic_units": tuple(_units(_stack(sd, "a2c_network.critic_mlp"))),
    }


def import_pulse_vae(sd: dict, activation: str = "silu", full_precision: bool = False, device=None) -> PulseVAE:
    """A reference im_z / distill checkpoint -> PulseVAE at its widths."""
    net = PulseVAE(**pulse_vae_spec_from_torch(sd), activation=activation, full_precision=full_precision,
                   device="cpu")
    parts = (import_z_encoder(sd, activation, device="cpu"), import_z_prior(sd, activation, device="cpu"),
             import_z_decoder(sd, activation, device="cpu"))
    for name, part in zip(("encoder", "prior", "decoder"), parts):
        getattr(net, name).load_state_dict(part.state_dict())
    trunk, head = import_critic(sd, activation, device="cpu")
    net.critic.load_state_dict(trunk.state_dict())
    net.critic_head.load_state_dict(head.state_dict())
    return net.to(resolve_device(device))


def import_pnn(sd: dict, prefix: str = "a2c_network.pnn", activation: str = "relu",
               device=None) -> tuple[PNN, dict]:
    """The reference PNN (`actors.{c}` Sequentials, the last Linear the
    action head; lateral stacks `u.{c-1}.{pc}.{k}`) -> (PNN, info
    {num_primitives, units, has_lateral, action_dim}). The lateral
    `u.{c-1}.{pc}.{k}` maps column pc's layer-k activation into column c's
    layer k+1 (`lat{pc}to{c}_l{k+1}`); the reference's forward uses only the
    first of each stack, and a stack's Linear that no hidden layer takes is
    not imported."""
    keys = sorted({(int(m.group(1)), int(m.group(2))) for k in sd
                   if (m := re.fullmatch(re.escape(prefix) + r"\.actors\.(\d+)\.(\d+)\.weight", k))})
    if not keys:
        raise KeyError(f"no PNN actors under {prefix!r}")
    N = max(c for c, _ in keys) + 1
    cols = [_stack(sd, f"{prefix}.actors.{c}") for c in range(N)]
    units = _units(cols[0][:-1])
    laterals = {}
    for k in sd:
        if m := re.fullmatch(re.escape(prefix) + r"\.u\.(\d+)\.(\d+)\.(\d+)\.weight", k):
            laterals[f"lat{int(m.group(2))}to{int(m.group(1)) + 1}_l{int(m.group(3)) + 1}"] = torch.as_tensor(sd[k])
    info = {"num_primitives": N, "units": tuple(units), "has_lateral": bool(laterals),
            "action_dim": int(cols[0][-1][0].shape[0])}
    net = PNN(int(cols[0][0][0].shape[1]), info["action_dim"], N, units, activation, has_lateral=bool(laterals),
              device="cpu")
    with torch.no_grad():
        for li in range(len(units)):
            net.weight[li].copy_(torch.stack([cols[c][li][0].T for c in range(N)]))
            net.bias[li].copy_(torch.stack([cols[c][li][1] for c in range(N)]))
        net.out_weight.copy_(torch.stack([cols[c][-1][0].T for c in range(N)]))
        net.out_bias.copy_(torch.stack([cols[c][-1][1] for c in range(N)]))
        for name, p in net.lateral.items():
            p.copy_(laterals[name].T)
    return net.to(resolve_device(device)), info


def import_mcp_composer(sd: dict, prefix: str = "a2c_network.composer", activation: str = "relu",
                        final: str = "softmax", device=None) -> MCPComposer:
    """The composer MLP (its last Linear the weights' logits) ->
    MCPComposer. `final` is its head: "softmax" for the trained MCP policy,
    an activation for the reference's distillation teacher, which rebuilds
    the composer from its state dict with a plain activation in the
    softmax's place."""
    *trunk, head = _stack(sd, prefix)
    net = MCPComposer(int(trunk[0][0].shape[1]), int(head[0].shape[0]), _units(trunk), activation, final,
                      device="cpu")
    _copy(_linears(net.trunk) + [net.logits], trunk + [head])
    return net.to(resolve_device(device))


def import_running_mean_std(sd: dict, prefix: str = "running_mean_std", device=None) -> RunningMeanStd:
    """rl-games RunningMeanStd buffers -> RunningMeanStd (float32)."""
    dev = resolve_device(device)
    return RunningMeanStd(**{k: torch.as_tensor(sd[f"{prefix}.{n}"]).to(dev, torch.float32)
                             for k, n in (("mean", "running_mean"), ("var", "running_var"), ("count", "count"))})
