#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into one the PyTorch port reads.

    python3 scripts/jax_checkpoint_to_torch.py \\
        --config racformer_tpu/configs/racformer_r50_nuimg_704x256_f8.py \\
        SRC OUT_WORK_DIR [--override k=v ...] [--ema]

SRC is a work dir of `train.py` (orbax checkpoints: the newest one's
weights and BatchNorm statistics are restored with
`racformer_tpu.train.checkpoint.CheckpointManager.restore_latest_eval`, and
with `--ema` its EMA parameters too) or a pickle of `{'params',
'batch_stats'}` whose leaves may be JAX arrays. The variables are
converted with the port's `state_dict_from_jax` into the port model of the
same config and written, verified, as the port train driver's checkpoint
layout, `OUT_WORK_DIR/checkpoints/<step>/state.pth` (step 0 for a pickle),
without optimizer state and with the EMA beside the weights when asked for.
`python -m racformer_tpu_torch.eval --checkpoint OUT_WORK_DIR` then reads
it. This script imports the JAX package; the port never does.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("src", help="a train.py work dir or a variables pickle")
    p.add_argument("out", help="the port work dir to write")
    p.add_argument("--override", nargs="+", default=[])
    p.add_argument("--ema", action="store_true",
                   help="also convert the checkpoint's EMA parameters")
    return p.parse_args(argv)


def jax_variables(cfg, src: str, ema: bool):
    """(step, {'params', 'batch_stats'} as numpy, EMA params or None)."""
    import jax
    import jax.numpy as jnp

    from racformer_tpu.model import RaCFormer as JaxRaCFormer
    from racformer_tpu.train.checkpoint import CheckpointManager

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    if os.path.isfile(src):
        with open(src, "rb") as f:
            variables = dict(pickle.load(f))
        if ema:
            raise SystemExit("--ema needs a train.py work dir")
        return 0, {k: to_np(variables[k]) for k in ("params", "batch_stats")}, None
    model_cfg = dict(cfg.model)
    if "num_classes" not in model_cfg and cfg.get("class_names"):
        model_cfg["num_classes"] = len(cfg.class_names)
    if cfg.get("decoder"):
        model_cfg.setdefault("decoder", dict(cfg.decoder))
    model = JaxRaCFormer(**model_cfg, train_mode=False)
    B, T, N = 1, model.num_frames, model.num_cams
    (H, W), P = model.image_hw, cfg.radar["max_points"]
    eye = jnp.tile(jnp.eye(4), (B, T, N, 1, 1))
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((B, T, N, H, W, 3)),
        jnp.zeros((B, T, P, 7)), jnp.ones((B, T, P), bool),
        jnp.zeros((B, T, N, H, W)), jnp.zeros((B, T, N, H, W)), eye, eye,
        jnp.zeros((B, T)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    mgr = CheckpointManager(src, verify=False)
    restored = mgr.restore_latest_eval(template["params"],
                                       template.get("batch_stats", {}))
    if restored is None:
        raise SystemExit(f"no checkpoint under {src}")
    step, params, batch_stats = restored
    ema_params = None
    if ema:
        ema_params = to_np(mgr.restore_latest_eval(
            template["params"], template.get("batch_stats", {}),
            use_ema=True)[1])
    return int(step), {"params": to_np(params),
                       "batch_stats": to_np(batch_stats)}, ema_params


def main(argv=None):
    args = parse_args(argv)
    from racformer_tpu.config import Config as JaxConfig

    from racformer_tpu_torch.config import Config
    from racformer_tpu_torch.model import RaCFormer, config_kwargs
    from racformer_tpu_torch.tools.convert_weights import state_dict_from_jax
    from racformer_tpu_torch.train.checkpoint import CheckpointManager

    step, variables, ema_params = jax_variables(
        JaxConfig.fromfile(args.config).merge_override(args.override),
        args.src, args.ema)
    cfg = Config.fromfile(args.config).merge_override(args.override)
    model = RaCFormer(**config_kwargs(cfg))
    model.load_state_dict(state_dict_from_jax(variables, model))
    ema = None
    if ema_params is not None:
        names = [n for n, _ in model.named_parameters()]
        ema = {n: t.float() for n, t in state_dict_from_jax(
            {"params": ema_params}, model, keys=set(names)).items()}
        ema = {n: ema[n] for n in names}
    info = CheckpointManager(args.out).save(step, model, ema=ema)
    print(f"wrote step {step} ({info['bytes']} B, verified) to "
          f"{os.path.join(args.out, 'checkpoints', str(step))}")
    return info


if __name__ == "__main__":
    main()
