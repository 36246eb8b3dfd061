"""The port's PHC curriculum tool (`python -m pulse_tpu_torch.curriculum`) and
`pulse_tpu_torch/scripts/forward_pmcp.py` against the JAX package's
`tools/curriculum.py` and `scripts/forward_pmcp.py`, on the CPU.

  * `pnn_params_from_actors` against the JAX tool's on the same two tiny
    actor-critics (flax params carried into the port), leaf by leaf
    exactly, then one forward of the JAX PNN (`column_inputs`) and of the
    port's PNN from those parameters at float32 tolerance (1e-5);
  * `copy_pnn_column` against the JAX script's, exactly;
  * `ladder_prob`, the ladder's level advance, the specialists' order, the
    `final` choice and `column_union_success` against values worked out
    from the JAX tool's lines (`tools/curriculum.py` :390-394, :433-434,
    :441-456, :913-920);
  * a tiny end-to-end run (8 envs, 32-24 columns) with every stage: three
    columns, a one-hot specialist that stops early, the sharp-turn ladder,
    the amp_getup column and the getup composer with its gate pretrain.
    `im_eval` over full clips costs ~8 s a call here, so it is replaced by
    a fixed failure pattern per evaluated policy (tests/test_torch_eval.py
    holds im_eval itself to the JAX package). The run stops after
    amp_getup (`--stop_after`), resumes from the snapshots, and a third run
    restores every stage and trains nothing. It checks the stage order and
    labels, the PMCP weights each stage's resets draw from, that column
    k+1 starts from column k's weights, the three repairs of the JAX
    tool's faults (partial.json complete at the end, written after the
    amp_getup column, stage labels on the columns' entries) and that the
    report holds every key of `quality/curriculum_r5.json`.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.learning.networks import ActorCritic as JaxActorCritic
from pulse_tpu.learning.pnn import PNN as JaxPNN

from jax_reference import module_reference_compiles
from torch_close import assert_close

from pulse_tpu_torch import curriculum
from pulse_tpu_torch.eval.im_eval import EvalResult
from pulse_tpu_torch.learning.amp_agent import AMPAgent
from pulse_tpu_torch.learning.networks import actor_critic_from_jax
from pulse_tpu_torch.learning.pnn import pnn_from_jax
from pulse_tpu_torch.learning.ppo import PPOAgent
from pulse_tpu_torch.scripts import forward_pmcp

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

ROOT = Path(__file__).resolve().parent.parent
OBS, ACT, UNITS = 20, 5, (16, 12)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    saved = list(sys.path)
    try:
        return _load("jax_curriculum_tool", "tools/curriculum.py"), _load("jax_forward_pmcp", "scripts/forward_pmcp.py")
    finally:
        sys.path[:] = saved


def _jax_actor_params(seed):
    net = JaxActorCritic(action_dim=ACT, actor_units=UNITS, critic_units=UNITS)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))["params"]
    return jax.tree.map(np.asarray, params)


def test_pnn_params_from_actors_and_pnn_forward_match_jax(jax_tools):
    tool, _ = jax_tools
    jparams = [_jax_actor_params(s) for s in (1, 2)]
    want = tool.pnn_params_from_actors(jparams, len(UNITS))
    got = curriculum.pnn_params_from_actors([actor_critic_from_jax(p, device="cpu").state_dict() for p in jparams],
                                            len(UNITS))
    assert sorted(got) == sorted(want)
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf].numpy(), np.asarray(want[name][leaf]), err_msg=name)
    x = np.random.default_rng(0).standard_normal((3, 2, OBS)).astype(np.float32)
    jpnn = JaxPNN(action_dim=ACT, num_primitives=2, units=UNITS, activation="silu", has_lateral=False,
                  column_inputs=True)
    jout = jpnn.apply({"params": want}, jnp.asarray(x))
    out = pnn_from_jax(got, "silu", column_inputs=True, device="cpu")(torch.as_tensor(x))
    assert out.shape == (3, 2, ACT)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)


def test_copy_pnn_column_matches_jax(jax_tools):
    _, script = jax_tools
    rng = np.random.default_rng(1)
    params = {f"col{c}_{n}": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                              "bias": rng.standard_normal(3).astype(np.float32)}
              for c in range(3) for n in ("dense0", "dense1", "out")}
    want = script.copy_pnn_column(params, 1, 2)
    got = forward_pmcp.copy_pnn_column(jax.tree.map(torch.as_tensor, params), 1, 2)
    assert sorted(got) == sorted(want)
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf].numpy(), np.asarray(want[name][leaf]), err_msg=name)
    # a copy, not a view of column 1
    got["col2_out"]["bias"] += 1.0
    assert not torch.equal(got["col2_out"]["bias"], got["col1_out"]["bias"])


def test_ladder_order_final_and_union_match_the_jax_lines():
    # :390-394: 1e-6 everywhere, 0.4 / (level + 1) up to the level, +0.6 on it
    np.testing.assert_allclose(curriculum.ladder_prob(0, 5), np.array([1.0, 1e-6, 1e-6, 1e-6, 1e-6]) / (1 + 4e-6))
    np.testing.assert_allclose(curriculum.ladder_prob(2, 5),
                               np.array([0.4 / 3, 0.4 / 3, 0.4 / 3 + 0.6, 1e-6, 1e-6]) / (1 + 2e-6))
    np.testing.assert_allclose(curriculum.ladder_prob(4, 5), np.array([0.08, 0.08, 0.08, 0.08, 0.68]))
    # :433-434: advance over the passed levels from the current one, never back
    assert curriculum.ladder_level(0, [True, True, False, True, False]) == 2
    assert curriculum.ladder_level(2, [False, False, False, True, False]) == 2
    assert curriculum.ladder_level(3, [True, True, True, True, True]) == 4
    # :441-456: by clip id, or by (family, level) on the graded suite
    assert curriculum.specialist_order(np.array([0, 1, 0, 1, 1, 0], bool)) == [1, 3, 4]
    fams = {"walk": [0, 2, 4], "jump": [1, 3, 5]}
    assert curriculum.specialist_order(np.array([1, 1, 0, 1, 1, 1], bool), fams) == [1, 3, 5, 0, 4]

    def ev(fails, pa):
        return EvalResult(0.0, 0.0, 0.0, pa, 0.0, 0.0, np.array(fails, bool))

    # :913-916: fewest failures, then the lowest MPJPE-pa, the first such
    evals = [ev([1, 1, 0], 50.0), ev([1, 0, 0], 90.0), ev([0, 1, 0], 80.0), ev([0, 0, 1], 80.0)]
    assert curriculum.final_index(evals) == 2
    # :918-920: clips that some column passes
    assert curriculum.union_success([e.failed_motions for e in evals]) == 3
    assert curriculum.union_success([[1, 1, 0], [1, 0, 0]]) == 2


# ---------------------------------------------------------------------------- #
# the tiny end-to-end run
# ---------------------------------------------------------------------------- #

# failed clips of each policy evaluated, in the order policies are first
# seen: on the suite, on the sharp-turn ladder, and the composer on the MCP env
SUITE_FAILS = [{1, 3, 4},            # col0
               {1, 3, 4},            # col1 -> still failed {1, 3, 4}
               {0, 3, 4},            # col2 -> {3, 4}: the specialists' clips
               {0, 1, 2, 4, 5},      # spec_getup_supine at its first in-training eval: passes -> early stop
               {0, 1, 2, 3, 5},      # the sharp-turn ladder's specialist
               {1, 4, 5}]            # amp_getup
LADDER_FAILS = [{1, 2, 3, 4}]        # level 0 passes -> level 1
COMPOSER_FAILS = [{4, 5},            # the pretrained gate: fails clips some column passes -> PPO
                  set()]             # after PPO: the best, shipped
FLAGS = ["--device", "cpu", "--units", "32,24", "--envs", "8", "--horizon", "4", "--minibatch", "16",
         "--epochs", "1", "--hard_epochs", "1", "--composer_epochs", "1", "--specialist_epochs", "2",
         "--spec_eval_every", "1", "--ladder_eval_every", "1", "--sharp_curriculum", "--amp_getup_epochs", "2",
         "--gate_pretrain_rounds", "1", "--num_fall_states", "8", "--fall_settle_steps", "2"]
STAGES = ["col0", "col1", "col2", "spec_getup_supine", "spec_sharp_turns_ladder", "amp_getup", "composer"]


def _checksum(policy) -> tuple:
    return tuple(round(float(p.detach().double().sum()), 6) for p in policy.network.parameters())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("curriculum")
    seen = {"im": {}, "ladder": {}, "mcp": {}}
    patterns = {"im": SUITE_FAILS, "ladder": LADDER_FAILS, "mcp": COMPOSER_FAILS}
    log = {"stage": None, "epochs": []}

    def fake_eval(env, policy_fn, batch_size=64):
        kind = "mcp" if hasattr(env, "pnn") else ("ladder" if env.motion.num_motions == 5 else "im")
        key = _checksum(policy_fn)
        if key not in seen[kind]:
            seen[kind][key] = len(seen[kind])
        fails = patterns[kind][min(seen[kind][key], len(patterns[kind]) - 1)]
        M = env.motion.num_motions
        failed = np.isin(np.arange(M), sorted(fails))
        g = np.full(M, 100.0) + 10.0 * np.arange(M)
        return EvalResult(float(1 - failed.mean()), 100.0, 80.0, 60.0 + len(fails), 1.0, 1.0, failed,
                          per_motion_mpjpe_g=g, per_motion_mpjpe_l=g, per_motion_steps=np.full(M, 10.0))

    real_stage = curriculum.Curriculum._stage

    def stage(self, label, kind, body):
        log["stage"] = label
        return real_stage(self, label, kind, body)

    def counted(real):
        def epoch(agent, ts):
            net = getattr(ts, "ppo", ts).network
            log["epochs"].append({"stage": log["stage"], "prob": agent.env.motion.sampling_prob.clone(),
                                  "weights": {k: v.clone() for k, v in net.state_dict().items()},
                                  "envs": agent.env.motion.num_motions, "env": type(agent.env).__name__})
            return real(agent, ts)
        return epoch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(curriculum, "im_eval", fake_eval)
        mp.setattr(curriculum.Curriculum, "_stage", stage)
        mp.setattr(PPOAgent, "train_epoch", counted(PPOAgent.train_epoch))
        mp.setattr(AMPAgent, "train_epoch", counted(AMPAgent.train_epoch))
        args = [*FLAGS, "--out", str(out)]
        stopped = curriculum.main([*args, "--stop_after", "amp_getup"])
        partial_at_stop = json.loads((out / "partial.json").read_text())
        epochs_a, log["epochs"] = log["epochs"], []
        resumed = curriculum.main(args)
        epochs_b, log["epochs"] = log["epochs"], []
        restored = curriculum.main(args)
        epochs_c = log["epochs"]
    return dict(out=out, stopped=stopped, partial_at_stop=partial_at_stop, resumed=resumed, restored=restored,
                epochs_a=epochs_a, epochs_b=epochs_b, epochs_c=epochs_c)


def test_stages_run_in_order_with_labels(runs):
    stopped, resumed = runs["stopped"], runs["resumed"]
    assert stopped["stopped_after"] == "amp_getup"
    assert [s["stage"] for s in stopped["stages"]] == STAGES[:-1]
    assert not any(s["restored"] for s in stopped["stages"])
    assert [s["stage"] for s in resumed["stages"]] == STAGES
    assert [s["restored"] for s in resumed["stages"]] == [True] * 6 + [False]
    assert [e["stage"] for e in resumed["columns"]] == STAGES[:-1]
    assert resumed["specialists"] == ["getup_supine", "sharp_turns"]
    assert resumed["amp_getup"]["stage"] == "amp_getup" and resumed["amp_getup"]["success"] == 3
    assert all(s["finite_losses"] for s in stopped["stages"] + resumed["stages"])
    spec, ladder = stopped["stages"][3], stopped["stages"][4]
    assert spec["epochs"] == 2            # stopped early at its first in-training eval
    assert ladder["ladder_levels"] == [[1, 1]] or ladder["ladder_levels"] == [(1, 1)]


def test_each_stage_trains_from_its_source_on_its_pmcp_weights(runs):
    ep = runs["epochs_a"] + runs["epochs_b"]
    by_stage = {}
    for e in ep:
        by_stage.setdefault(e["stage"], []).append(e)
    assert list(by_stage) == STAGES
    uniform = torch.full((6,), 1 / 6)
    assert_close(by_stage["col0"][0]["prob"], uniform)
    assert_close(by_stage["col1"][0]["prob"], torch.tensor([0, 1, 0, 1, 1, 0]) / 3.0)
    assert_close(by_stage["col2"][0]["prob"], torch.tensor([0, 1, 0, 1, 1, 0]) / 3.0)
    assert_close(by_stage["spec_getup_supine"][0]["prob"], torch.tensor([0, 0, 0, 1.0, 0, 0]))
    ladder = by_stage["spec_sharp_turns_ladder"]
    assert {e["envs"] for e in ladder} == {5}
    np.testing.assert_allclose(ladder[0]["prob"].numpy(), curriculum.ladder_prob(0, 5), rtol=1e-6)
    np.testing.assert_allclose(ladder[1]["prob"].numpy(), curriculum.ladder_prob(0, 5), rtol=1e-6)
    assert by_stage["amp_getup"][0]["env"] == "HumanoidImGetupEnv"
    assert by_stage["composer"][0]["env"] == "HumanoidImMCPGetupEnv"
    for s in ("amp_getup", "composer"):
        assert_close(by_stage[s][0]["prob"], uniform)
    # column k+1 starts from column k's last weights; the specialists and
    # amp_getup from column 0's
    out = runs["out"]
    snap = {s: torch.load(out / f"{s}.pt", weights_only=True)["network"] for s in STAGES[:-1]}
    for first, src in (("col1", "col0"), ("col2", "col1"), ("spec_getup_supine", "col0"),
                       ("spec_sharp_turns_ladder", "col0"), ("amp_getup", "col0")):
        w = by_stage[first][0]["weights"]
        assert all(torch.equal(w[k], snap[src][k]) for k in snap[src]), (first, src)
    assert not all(torch.equal(by_stage["col1"][0]["weights"][k], snap["col1"][k]) for k in snap["col1"])


def test_report_keys_final_and_repairs(runs):
    resumed, out = runs["resumed"], runs["out"]
    r5 = json.loads((ROOT / "quality" / "curriculum_r5.json").read_text())
    assert set(r5) <= set(resumed)
    assert set(r5["columns"][0]) <= set(resumed["columns"][0])
    assert json.loads((out / "curriculum.json").read_text()) == json.loads(json.dumps(runs["restored"]))
    assert resumed["column_union_success"] == 6
    assert resumed["composer"]["success"] == 6 and resumed["final"] == resumed["composer"]
    assert resumed["epochs"] == {"col0": 1, "hard": 1, "composer": 1, "amp_getup": 2}
    assert resumed["composer_env"] == "getup" and resumed["sharp_curriculum"] is True
    assert resumed["port"] == "cpu" and resumed["gpu"] is None
    # the JAX tool's faults, repaired
    at_stop = runs["partial_at_stop"]
    assert at_stop["status"] == "partial" and at_stop["columns"][-1]["stage"] == "amp_getup"
    partial = json.loads((out / "partial.json").read_text())
    assert partial["status"] == "complete" and [c["stage"] for c in partial["columns"]] == STAGES[:-1]
    assert partial["composer"]["success"] == 6
    # the composer's frozen PNN, parameters named col{k}_*
    pnn = torch.load(out / "pnn6.pt", weights_only=True)
    assert sorted({k.split("_")[0] for k in pnn["params"]}) == [f"col{k}" for k in range(6)]
    assert pnn["obs_rms"]["mean"].shape[0] == 6


def test_a_finished_run_restores_every_stage_and_trains_nothing(runs):
    restored, resumed = runs["restored"], runs["resumed"]
    assert runs["epochs_c"] == []
    assert all(s["restored"] and s["epochs"] == 0 for s in restored["stages"])
    for key in ("columns", "composer", "final", "specialists", "amp_getup", "column_union_success"):
        assert restored[key] == resumed[key], key


def test_forward_pmcp_copies_a_curriculum_column_bitwise(runs, tmp_path):
    src = runs["out"] / "pnn6.pt"
    state = forward_pmcp.main(["--ckpt", str(src), "--column", "2", "--out", str(tmp_path / "next.pt"),
                               "--device", "cpu"])
    saved = torch.load(tmp_path / "next.pt", weights_only=True)
    orig = torch.load(src, weights_only=True)
    assert saved.keys() == orig.keys() and saved["activation"] == "silu"
    for name, leaves in orig["params"].items():
        want = orig["params"][name.replace("col3_", "col2_")] if name.startswith("col3_") else leaves
        for leaf in ("kernel", "bias"):
            assert torch.equal(saved["params"][name][leaf], want[leaf]), name
    assert torch.equal(state["obs_rms"]["mean"], orig["obs_rms"]["mean"])
