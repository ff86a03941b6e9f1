"""Port parity of ``make_train_step``: one and two steps with
``accum_steps`` 1 and 2 against the JAX package's ``make_train_step`` from
the same params (``params_from_jax``) and optimizer state
(``opt_state_from_jax``), on the RecurrentGemma-2B smoke config.  Inputs
are made with numpy from a seed and fed to both packages; each comparison
states its tolerance (the model's shared with ``test_torch_train.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_optimizer as jinit_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train import AdamWConfig, init_optimizer, make_train_step
from test_torch_train import (GRAD_MAX_FRAC, LOSS_RTOL, RNG_SEED, _batch,
                              _jax_model, _np, _port_model)

#: the train steps: grad norm within 1% (measured 0.4%); with AdamW's eps at
#: 1 (below), each parameter within PARAM_LR_FRAC of the learning rate a
#: step (measured 0.0055); m as the gradients; v, quadratic in them, within
#: twice their fraction
GNORM_RTOL, PARAM_LR_FRAC = 0.01, 0.05


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    """Two steps of ``make_train_step`` (``accum_steps`` 1 and 2: the
    microbatches are consecutive row blocks) against JAX's from the same
    params and optimizer state: loss, grad norm and step each step; the
    parameters, m and v after each.  AdamW's ``eps`` is 1 here: with
    ``eps`` at 1e-8 the update is about ``lr·sign(g)`` wherever |g| is
    small, so a gradient element near 0 whose sign the bf16 noise flips
    moves a parameter by 2·lr in one package and not the other; at 1 the
    update is smooth in g.  (``tests/test_torch_optim.py`` holds the update
    itself at the default to f32 ulps.)"""
    arch = "recurrentgemma-2b"
    jm, params = _jax_model(arch)
    tm = _port_model(arch)
    kw = dict(lr=1e-3, eps=1.0, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jm, JAdamWConfig(**kw),
                                     accum_steps=accum))
    tstep = make_train_step(tm, AdamWConfig(**kw), accum_steps=accum)
    jp, js = params, jinit_optimizer(params)
    ts = opt_state_from_jax(_np(js), tm)
    for i in range(2):
        batch = _batch(jm.cfg.vocab, 4, 16, RNG_SEED + 10 + i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        ts, met = tstep(ts, batch)
        assert int(met["step"]) == int(jmet["step"]) == i + 1
        assert met["step"].dtype == torch.int32
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=GNORM_RTOL)
        want = params_from_jax(_np(jp), tm)
        for name, p in tm.named_parameters():
            assert not p.requires_grad and p.grad is None
            assert float((p - want[name]).abs().max()) <= (
                PARAM_LR_FRAC * kw["lr"] * (i + 1)), name
        for k in ("m", "v"):
            wmv = params_from_jax(_np(js[k]), tm)
            for name, t in ts[k].items():
                scale = float(wmv[name].abs().max())
                frac = GRAD_MAX_FRAC * (2 if k == "v" else 1)
                assert float((t - wmv[name]).abs().max()) <= (
                    frac * scale), (k, name)


def test_accum_steps_must_divide_the_batch():
    """A batch of 3 rows in 2 microbatches raises before any step (JAX's
    reshape fails there too), where slicing would drop the last row."""
    tm = _port_model("recurrentgemma-2b")
    step = make_train_step(tm, AdamWConfig(), accum_steps=2)
    state = init_optimizer(tm)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    with pytest.raises(ValueError, match="does not divide"):
        step(state, _batch(tm.cfg.vocab, 3, 16, RNG_SEED))
    assert all(torch.equal(p, before[k]) for k, p in tm.named_parameters())
