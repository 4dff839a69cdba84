"""Shared set-up of the parity tests between satrans_tpu and satrans_torch.

Both packages get the same layout, the same parameters (drawn with numpy
from a seed, moved into the port through ``satrans_torch.bridge``) and the
same numpy inputs.
"""

import numpy as np

import jax

D_EMB = 8
META_UNITS = (D_EMB, 16, D_EMB)
LAYERS = 2
HEADS = 2


def columns(pkg, combiner="max"):
    """A large field, a second large field, the scenario column (vocab <= 256,
    so it lives in the side bank) and a varlen field."""
    f = pkg.features
    return [f.SparseFeature("f0", 300, D_EMB),
            f.SparseFeature("f1", 500, D_EMB),
            f.SparseFeature("domain", 5, D_EMB),
            f.VarLenSparseFeature("hist", 300, D_EMB, 3, combiner)]


def columns_no_varlen(pkg, combiner="max"):
    """Two large fields and the scenario column: the gather plan is one
    ``[B, 2]`` lookup, and at d=8 (16 logical rows a physical row) the two
    fields share physical row 18."""
    return columns(pkg)[:3]


def model_kwargs(mode="QK", relu_out=False, **extra):
    """SATrans keywords of both packages; ``extra`` adds or overrides."""
    kw = dict(domain_cols=["domain"], num_domains_list=[3],
              domain_att_layer_num=LAYERS, att_head_num=HEADS,
              meta_mode=mode, meta_dnn_hidden_units=META_UNITS[1:],
              relu_out=relu_out, dropout_rate=0.0)
    kw.update(extra)
    return kw


def random_params(params, seed=0, scale=0.3):
    """Every leaf of a JAX pytree redrawn N(0, scale) with numpy, so that
    the embeddings and MetaNets move the output (the default init keeps
    them near zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
        params)


def request(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"f0": rng.integers(1, 300, n), "f1": rng.integers(1, 500, n),
            "domain": rng.integers(1, 4, n),
            "hist": rng.integers(0, 300, (n, 3))}


def jax_and_port(mode="QK", relu_out=False, combiner="max", seed=0,
                 cols=columns, **extra):
    """(jax model, numpy params, port model on the CPU holding the same
    params).  ``cols`` gives the columns; ``extra`` more model keywords."""
    import satrans_torch
    import satrans_tpu
    from satrans_torch import bridge
    from satrans_torch.models import SATrans as TorchSATrans
    from satrans_tpu.models import SATrans

    kw = model_kwargs(mode, relu_out, **extra)
    jm = SATrans(layout=satrans_tpu.FeatureLayout(
        cols(satrans_tpu, combiner)), **kw)
    # every leaf is redrawn: the init's shapes alone (eager JAX init
    # compiles each of its small ops)
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(3))
    params = random_params(params, seed)
    tm = TorchSATrans(satrans_torch.FeatureLayout(
        cols(satrans_torch, combiner)), **kw, device="cpu")
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    return jm, params, tm


def port_fit(tm, x, y, mode, *, step_key=None, lr=0.01, seed=7,
             batch_size=16):
    """One epoch of the port's ``Trainer.fit`` on the CPU (``seed`` is the
    one ``test_torch_bank_train._jax_fit`` gives the JAX Trainer); returns
    each step's statistics as floats.  ``step_key`` replaces the
    Trainer's per-step dropout keys."""
    from satrans_torch.train import Trainer
    tr = Trainer(tm, seed=seed, device="cpu")
    tr.compile(learning_rate=lr, bank_update=mode)
    if step_key is not None:
        tr.step_key = step_key
    steps = []
    step = tr.train_step

    def record(*args):
        stats = step(*args)
        steps.append({k: float(v) for k, v in stats.items()})
        return stats

    tr.train_step = record
    tr.fit(x, y, batch_size=batch_size, epochs=1, verbose=0)
    return steps


def assert_fit_matches(j_steps, j_params, steps, tm, exclude=()):
    """The port's steps and parameters against the JAX Trainer's: the data
    and reg losses at rtol 1e-5, every parameter but those named in
    ``exclude`` at atol 5e-5 / rtol 1e-3 (tests/test_torch_train.py's
    tolerances)."""
    from satrans_torch import bridge
    assert len(j_steps) == len(steps)
    for js, ts in zip(j_steps, steps):
        assert js["count"] == ts["count"]
        for k in ("loss", "reg_loss"):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)
    got = tm.state_dict()
    for name, w in bridge.from_jax_params(j_params, tm).items():
        if name in exclude:
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=5e-5,
                                   rtol=1e-3, err_msg=name)


# compiled without XLA's backend optimizations: the dropout's threefry
# rounds compile a third as long, the same program
FAST = {"xla_backend_optimization_level": 0}


def compile_fast(jitted):
    """``jitted`` (a ``jax.jit`` function), compiled with FAST at its first
    call; every call takes the first one's shapes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options=FAST))
        return compiled[0](*args)

    return call


def fast_vjp(fn, args, g):
    """``(fn(*args), the pullback of g)`` from one call compiled with FAST:
    the interpret-mode kernels compiled once, not run op by op."""
    def fwd_bwd(*a):
        y, pullback = jax.vjp(fn, *a[:-1])
        return y, pullback(a[-1])

    return compile_fast(jax.jit(fwd_bwd))(*args, g)


def fast_steps(trainer):
    """The JAX ``trainer``'s train and eval steps built by
    ``_build_steps``, each compiled with FAST."""
    for name in ("_train_step", "_eval_step"):
        step = getattr(trainer, name)
        if hasattr(step, "lower"):  # not compiled with FAST yet
            setattr(trainer, name, compile_fast(step))


def fast_trainer_steps(monkeypatch):
    """Every JAX ``Trainer`` built from now on in the test compiles its
    steps with FAST."""
    from satrans_tpu.train import Trainer
    build = Trainer._build_steps

    def build_fast(trainer):
        build(trainer)
        fast_steps(trainer)

    monkeypatch.setattr(Trainer, "_build_steps", build_fast)
