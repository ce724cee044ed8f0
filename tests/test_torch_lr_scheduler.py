"""The port's learning-rate schedulers against the reference's.

Every scheduler of ``mxnet_tpu.lr_scheduler`` (Factor, MultiFactor, Poly,
Cosine), without warm-up and with a linear and a constant one, built with
the same arguments in both packages and called for ``num_update`` 0..N in
order (Factor and MultiFactor change their own state when called, so the
order matters): the rates must be equal, and so must the state they carry.
Both are the same Python arithmetic on floats, so the tolerance is 0.
"""
import pytest

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

N = 40
SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=3, factor=0.1, stop_factor_lr=1e-4, base_lr=1.0)),
    ("MultiFactorScheduler", dict(step=[5, 12, 30], factor=0.3, base_lr=0.2)),
    ("PolyScheduler", dict(max_update=30, base_lr=0.1, pwr=2, final_lr=1e-3)),
    ("CosineScheduler", dict(max_update=33, base_lr=0.5, final_lr=0.01)),
]
WARMUPS = [{}, dict(warmup_steps=6, warmup_begin_lr=0.001, warmup_mode="linear"),
           dict(warmup_steps=4, warmup_begin_lr=0.02, warmup_mode="constant")]


@pytest.mark.parametrize("warmup", WARMUPS, ids=["none", "linear", "constant"])
@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULERS)])
def test_scheduler_matches_reference(name, kw, warmup):
    from mxnet_tpu import lr_scheduler as ref_sched
    port = getattr(mt.lr_scheduler, name)(**kw, **warmup)
    ref = getattr(ref_sched, name)(**kw, **warmup)
    got = [port(t) for t in range(N + 1)]
    expect = [ref(t) for t in range(N + 1)]
    assert got == expect
    assert port.state_dict() == ref.state_dict()
    if warmup:
        assert got[0] == warmup["warmup_begin_lr"]


def test_optimizer_reads_lr_through_scheduler():
    """``base_lr`` becomes the optimizer's learning rate; the rate follows
    ``num_update``; ``set_learning_rate`` raises while a scheduler is set."""
    sched = mt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = mt.optimizer.SGD(learning_rate=0.8, lr_scheduler=sched)
    assert sched.base_lr == 0.8
    rates = []
    for t in range(1, 7):
        opt.num_update = t
        rates.append(opt.learning_rate)
    assert rates == [0.8, 0.8, 0.4, 0.4, 0.2, 0.2]
    with pytest.raises(mt.MXNetError, match="lr_scheduler"):
        opt.set_learning_rate(0.1)
    state = sched.state_dict()
    fresh = mt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    fresh.load_state_dict(state)
    assert fresh(6) == sched(6) == 0.2
