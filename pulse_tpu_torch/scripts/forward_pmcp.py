"""PNN progressive curriculum: advance to the next primitive column.

Counterpart of `scripts/forward_pmcp.py` (≙ the reference's
scripts/pmcp/forward_pmcp.py:55-59): after primitive k has trained on the
current (hard-negative) motion set, column k's weights are copied into
column k+1 as its initialization, and the failed-motion set the next stage
trains on is reported.

It reads a port checkpoint whose parameters are named `col{k}_*` (a
`torch.save` of a dict, the parameters under "params" or at its top
level), such as the frozen PNN the curriculum writes
(`python -m pulse_tpu_torch.curriculum` -> `<out>/pnn<N>.pt`), and writes
the same dict with column k copied onto k+1 to `--out`. The copy runs on
`--device` (the card unless given `--device cpu`); the file keeps CPU
tensors.

    python -m pulse_tpu_torch.scripts.forward_pmcp --ckpt output/curriculum/pnn3.pt
        --column 0 [--failed failed.json] --out output/pnn_next.pt [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def copy_pnn_column(params: dict, src: int, dst: int) -> dict:
    """Copy every col{src}_* parameter subtree onto col{dst}_*."""
    out = dict(params)
    pat = re.compile(rf"^col{src}_(.+)$")
    for name in list(params):
        m = pat.match(name)
        if m:
            out[f"col{dst}_{m.group(1)}"] = _tree_map(lambda x: x.clone(), params[name])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="copy PNN column k onto column k+1")
    ap.add_argument("--ckpt", required=True, help="a .pt file of col{k}_* parameters")
    ap.add_argument("--column", type=int, default=0)
    ap.add_argument("--failed", default="", help="JSON list of the failed motions (bools or ids)")
    ap.add_argument("--out", required=True, help="the .pt file to write")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from pulse_tpu_torch._device import resolve_device

    device = resolve_device(args.device)
    state = torch.load(args.ckpt, map_location=device, weights_only=True)
    params = state["params"] if "params" in state else state
    params = copy_pnn_column(params, args.column, args.column + 1)
    state = {**state, "params": params} if "params" in state else params
    torch.save(_tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state), args.out)
    print(f"copied column {args.column} -> {args.column + 1}; wrote {args.out}")

    if args.failed:
        with open(args.failed) as fh:
            failed = json.load(fh)
        n_failed = sum(failed) if isinstance(failed, list) else len(failed)
        print(f"next stage trains on {n_failed} failed motions")
    return state


if __name__ == "__main__":
    main()
