"""Data-parallel scaling-efficiency benchmark (BASELINE.md target: >=85%
examples/s efficiency from 1 device to N).

Runs the SimCSE item-tower train step at a fixed per-device batch over
growing data-parallel mesh sizes and reports examples/s + efficiency vs
the 1-device run. With --cpu it exercises the mechanics on the virtual CPU
mesh (pass --devices to cap); on several GPUs it measures real scaling —
the code path is identical.

Prints one JSON line per mesh size.
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--per-device-batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="force the virtual CPU platform (mechanics mode)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", args.devices or 8)
        except Exception:
            pass
    import jax.numpy as jnp

    from recsys.config import (
        Config, DataConfig, ItemTowerConfig, MeshConfig, VocabConfig)
    from recsys.data.dataset import slice_item_batch, tokenize_items
    from recsys.data.synthetic import generate_dataset
    from recsys.data.vocab import StdVocab
    from recsys.parallel.mesh import build_mesh, data_sharding, replicated
    from recsys.train.simcse import (
        build_model, init_params, make_optimizer, make_train_step)
    from recsys.train.state import TrainState

    n_avail = len(jax.devices())
    max_d = min(args.devices or n_avail, n_avail)
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= max_d]

    cfg = Config(
        data=DataConfig(num_items=512, num_users=32, days=30, seed=0),
        vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=1024),
        item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1))
    items, _, _ = generate_dataset(cfg.data)
    tensors = tokenize_items(items, StdVocab(), cfg.vocab)
    model = build_model(cfg, StdVocab().size, tensors["std"].shape[1])
    params0 = init_params(model, tensors, jax.random.PRNGKey(0))

    base_eps = None
    rng = np.random.default_rng(0)
    for d in sizes:
        mesh = build_mesh(MeshConfig(num_data=d, num_model=1), jax.devices()[:d])
        bs = args.per_device_batch * d
        tx = make_optimizer(cfg, params0, total_steps=1000)
        state = jax.device_put(TrainState.create(params0, tx), replicated(mesh))
        step_fn = make_train_step(model, cfg)
        batches = []
        for _ in range(args.steps + 2):
            idx = rng.integers(0, tensors["std"].shape[0], bs)
            batches.append(jax.device_put(slice_item_batch(tensors, idx),
                                          data_sharding(mesh)))
        key = jax.random.PRNGKey(0)
        for b in batches[:2]:
            key, sub = jax.random.split(key)
            state, aux = step_fn(state, b, sub)
        _ = float(aux["loss"])
        t0 = time.perf_counter()
        for b in batches[2:]:
            key, sub = jax.random.split(key)
            state, aux = step_fn(state, b, sub)
        _ = float(aux["loss"])
        dt = time.perf_counter() - t0
        eps = args.steps * bs / dt
        base_eps = base_eps or eps
        print(json.dumps({
            "devices": d, "global_batch": bs,
            "examples_per_s": round(eps, 1),
            "scaling_efficiency": round(eps / (base_eps * d), 3),
        }))


if __name__ == "__main__":
    main()
