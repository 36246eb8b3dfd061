"""HumanoidImMCP: the policy outputs composer weights over frozen PNN
primitives, and the env executes their blend.

Counterpart of `pulse_tpu/env/humanoid_im_mcp.py` (PHC's MCP, and its getup
variant): the action space is the N composer weights; each step evaluates
the frozen PNN on the pre-step observation and executes
clip(sum_i softmax(gate_temp * w)_i prim_i, -1, 1) through the env's PD
mapping (69 dof). Only the `motor_actions` hook changes, so the plain env
keeps K1 → K2 and the getup env K3 → RA → K2. The PNN runs in float32
outside any autocast (`learning/pnn.py`) and is not trained.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.env.humanoid_im import EnvState, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import HumanoidImGetupEnv
from pulse_tpu_torch.learning.pnn import PNN, compose_actions


class _MCPMixin:
    """The action pathway: composer weights -> blended primitive action."""

    def init_mcp(self, pnn: PNN, obs_rms=None, gate_temp: float = 1.0) -> None:
        """`obs_rms`: the frozen input normalizer the columns were trained
        under (stacked [N, obs] leaves with `column_inputs`), or None.
        `gate_temp` scales the clipped [-1, 1] weights before the softmax, so
        that +-1 can route almost all control to one column."""
        if pnn.action_dim != self.model.num_dof or pnn.in_dim != self.obs_dim:
            raise ValueError(f"PNN {pnn.in_dim} -> {pnn.action_dim}, env obs {self.obs_dim}, dof "
                             f"{self.model.num_dof}")
        self.pnn = pnn.requires_grad_(False)
        self.pnn_obs_rms = obs_rms
        self.gate_temp = gate_temp
        self.action_dim = pnn.num_primitives

    def _ctor_kwargs(self) -> dict:
        return {"pnn": self.pnn, "obs_rms": self.pnn_obs_rms, "gate_temp": self.gate_temp}

    @torch.no_grad()
    def primitive_actions(self, obs: torch.Tensor) -> torch.Tensor:
        """[B, N, A] every column's action on observations [B, obs]."""
        pnn = self.pnn
        if pnn.column_inputs:
            obs = obs[..., None, :]
        if self.pnn_obs_rms is not None:
            obs = self.pnn_obs_rms.normalize(obs)
        elif pnn.column_inputs:
            obs = obs.expand(*obs.shape[:-2], pnn.num_primitives, obs.shape[-1])
        return pnn(obs)

    def motor_actions(self, state: EnvState, weights: torch.Tensor) -> torch.Tensor:
        """The blend of the primitives on the pre-step observation."""
        with torch.autocast(weights.device.type, enabled=False):
            w = torch.softmax(weights.float() * self.gate_temp, dim=-1)
            return torch.clamp(compose_actions(w, self.primitive_actions(state.obs)), -1.0, 1.0)


class HumanoidImMCPEnv(_MCPMixin, HumanoidImEnv):
    def __init__(self, model, motion, config=None, device=None, seed: int = 0, *, pnn: PNN, obs_rms=None,
                 gate_temp: float = 1.0):
        super().__init__(model, motion, config, device=device, seed=seed)
        self.init_mcp(pnn, obs_rms, gate_temp)


class HumanoidImMCPGetupEnv(_MCPMixin, HumanoidImGetupEnv):
    def __init__(self, model, motion, config=None, device=None, seed: int = 0, *, pnn: PNN, obs_rms=None,
                 gate_temp: float = 1.0):
        super().__init__(model, motion, config, device=device, seed=seed)
        self.init_mcp(pnn, obs_rms, gate_temp)
