"""The reference's launch cells, for ``test_torch_cells.py``,
``test_torch_launch.py`` and ``test_torch_launch_mesh.py``: run as a
subprocess with four forced host
devices, so the test process's JAX keeps its own device count.

    python tests/_torch_launch_ref.py memory OUT.json ARCH [ARCH ...]
    python tests/_torch_launch_ref.py flops OUT.json ARCH [ARCH ...]
    python tests/_torch_launch_ref.py numbers OUT_DIR TCFG_JSON

- ``memory``: ``memory_analysis().argument_size_in_bytes`` of the
  reduced cells of ``ARCH`` compiled on a (2, 2) mesh;
- ``flops``: ``roofline_cell``'s differenced ``cost_analysis()`` FLOPs of
  the reduced cells of ``ARCH`` on ``make_host_mesh()``;
- ``numbers``: the reduced qwen2-0.5b train cell and DeepSeek-V2-Lite
  prefill cell jitted on the (2, 2) mesh (``TCFG_JSON``: ``TrainConfig``'s
  keywords): their parameters and inputs (``OUT_DIR/<arch>.pkl``) and
  their logits, or the train step's metrics and new state (``(params,
  (mu, nu, master, count))``, numpy leaves, as
  ``convert.train_state_from_jax`` takes it) from the parameters as drawn
  and, under ``"float32"``, cast to float32.  DeepSeek-V2-Lite's record
  also holds ``"serve"``: on the same parameters, the jitted model's
  prefill of ``SERVE_PROMPT`` tokens into a ``SERVE_LEN``-deep cache and
  ``SERVE_STEPS`` decode steps on seeded tokens (:func:`serve_numbers`).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

FAMILIES = ("qwen2-0.5b", "deepseek-v2-lite-16b", "rwkv6-7b",
            "recurrentgemma-2b", "seamless-m4t-medium", "llava-next-mistral-7b")
KINDS = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}   # S, B
SHARDED = {"qwen2-0.5b": "train", "deepseek-v2-lite-16b": "prefill"}
GRAD_ACCUM = 2
SEED = 0
SERVE_PROMPT, SERVE_LEN, SERVE_STEPS = 60, 64, 2


def shape_of(kind):
    from repro.configs.base import ShapeConfig
    S, B = KINDS[kind]
    return ShapeConfig(f"t_{kind}", S, B, kind)


def batch_of(cfg, shape, seed: int = SEED) -> dict:
    """Seeded inputs of the cell's specs as numpy arrays (bf16 ones held
    as float32, already rounded)."""
    import ml_dtypes
    from repro.models import get_model
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in get_model(cfg).input_specs(shape).items():
        if s.dtype == np.int32:
            out[name] = rng.integers(0, cfg.vocab_size, s.shape).astype(np.int32)
        else:
            out[name] = rng.standard_normal(s.shape).astype(
                ml_dtypes.bfloat16).astype(np.float32)
    return out


def serve_numbers(cfg, params, B: int) -> dict:
    """The jitted model's (no mesh) prefill of a seeded ``(B,
    SERVE_PROMPT)`` prompt into a ``SERVE_LEN``-deep cache, then
    ``SERVE_STEPS`` decode steps on seeded tokens: the prompt, the tokens
    and the three calls' logits (float32), from ``params`` (``"logits"``)
    and from them cast to float32 (``"logits_f32"``)."""
    import jax.numpy as jnp
    from repro.models import get_model
    model = get_model(cfg)
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab_size,
                          (B, SERVE_PROMPT)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size,
                          (SERVE_STEPS, B, 1)).astype(np.int32)
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    out = {"prompt": prompt, "tokens": tokens, "len": SERVE_LEN}
    for key, p in (("logits", params), ("logits_f32", jax.tree.map(
            lambda a: a.astype(jnp.float32), params))):
        logits, cache = prefill(p, {"tokens": jnp.asarray(prompt)},
                                model.init_cache(B, SERVE_LEN))
        calls = [logits]
        for i, tok in enumerate(tokens):
            logits, cache = decode(p, jnp.asarray(tok), cache,
                                   jnp.int32(SERVE_PROMPT + i))
            calls.append(logits)
        out[key] = [np.asarray(x.astype(jnp.float32)) for x in calls]
    return out


def main():
    import json

    from repro.configs.base import SHAPES, TrainConfig
    from repro.configs.registry import get_config
    from repro.launch.cells import build_cell, lower_cell
    from repro.launch.mesh import compat_make_mesh, make_host_mesh

    mode, out = sys.argv[1], sys.argv[2]
    if mode == "memory":
        mesh = compat_make_mesh((2, 2), ("data", "model"))
        res = {}
        for arch in sys.argv[3:]:
            for kind in KINDS:
                cell = build_cell(get_config(arch).reduced(), shape_of(kind),
                                  mesh, TrainConfig())
                ma = lower_cell(cell).compile().memory_analysis()
                res[f"{arch}/{kind}"] = ma.argument_size_in_bytes
        with open(out, "w") as f:
            json.dump(res, f)
    elif mode == "flops":
        from repro.launch.roofline import roofline_cell
        for kind in KINDS:
            SHAPES[f"t_{kind}"] = shape_of(kind)
        res = {}
        for arch in sys.argv[3:]:
            for kind in KINDS:
                r = roofline_cell(arch, f"t_{kind}", mesh=make_host_mesh(),
                                  cfg_override=get_config(arch).reduced(),
                                  save=False)
                res[f"{arch}/{kind}"] = r.flops_dev
        with open(out, "w") as f:
            json.dump(res, f)
    elif mode == "numbers":
        import jax.numpy as jnp
        from repro.train import optim, step
        mesh = compat_make_mesh((2, 2), ("data", "model"))
        tcfg = json.loads(sys.argv[3])
        for arch, kind in SHARDED.items():
            cfg = get_config(arch).reduced()
            shape = shape_of(kind)
            cell = build_cell(cfg, shape, mesh, TrainConfig(**tcfg),
                              grad_accum=GRAD_ACCUM)
            params = cell.model.init(jax.random.PRNGKey(SEED))
            batch = batch_of(cell.cfg, shape)
            jbatch = {k: jnp.asarray(v, dtype=jnp.int32 if v.dtype == np.int32
                                     else jnp.bfloat16)
                      for k, v in batch.items()}
            fn = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                         out_shardings=cell.out_shardings)
            if kind == "train":
                def train(p):
                    state = step.TrainState(
                        params=p, opt=optim.init_opt_state(p, cell.tcfg))
                    new, metrics = fn(state, jbatch)
                    o = new.opt
                    return {
                        **{k: float(metrics[k]) for k in ("loss", "grad_norm",
                                                          "lr")},
                        "state": jax.tree.map(np.asarray, (
                            new.params, (o.mu, o.nu, o.master, o.count)))}
                result = train(params)
                result["float32"] = train(jax.tree.map(
                    lambda a: a.astype(jnp.float32), params))
            else:
                cache = cell.model.init_cache(shape.global_batch,
                                              shape.seq_len)
                logits, _ = fn(params, jbatch, cache)
                result = {"logits": np.asarray(logits.astype(jnp.float32)),
                          "serve": serve_numbers(cfg, params,
                                                 shape.global_batch)}
            with open(os.path.join(out, f"{arch}.pkl"), "wb") as f:
                pickle.dump({"params": jax.tree.map(np.asarray, params),
                             "batch": batch, "result": result}, f)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
