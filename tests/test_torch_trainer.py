"""The port's training loop and its parts (``train.py``'s Trainer, EMA,
batching, prefetch and host sharding, ``checkpoint.py``, ``profiler.py``)
on the CPU: EMA against the JAX package's on the same values; the loop,
the checkpointer's format (``torch.save``, not orbax) and the resume by
round trips: a resumed run equals the straight run, tensor for tensor."""

import threading
import time

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

import jax.numpy as jnp

from d3d_tpu.train import ema_init as j_ema_init
from d3d_tpu.train import ema_update as j_ema_update

from d3d_tpu_torch import profiler
from d3d_tpu_torch.checkpoint import TrainCheckpointer
from d3d_tpu_torch.models import PointPillars, PointPillarsConfig
from d3d_tpu_torch.models import make_anchors, pillarize, prepare_targets
from d3d_tpu_torch.models.pointpillars import make_train_step
from d3d_tpu_torch.train import (Trainer, batch_frames, ema_init,
                                 ema_update, init_variables, make_optimizer,
                                 prefetch, shard_frames_across_hosts,
                                 train_state)

from tests.test_torch_pointpillars import CFG

TINY = PointPillarsConfig(**CFG)


def _frames(seed, n):
    """n pillarized frames with 3 car-like gts each, as dicts of CPU
    tensors."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        pts = np.stack([rng.uniform(0, 16, 2048), rng.uniform(-8, 8, 2048),
                        rng.uniform(-3, 1, 2048), rng.random(2048)],
                       1).astype(np.float32)
        f, c, v = pillarize(torch.from_numpy(pts), TINY)
        gt = np.stack([rng.uniform(2, 14, 3), rng.uniform(-6, 6, 3),
                       np.full(3, -1.0), np.full(3, 3.9), np.full(3, 1.6),
                       np.full(3, 1.56), rng.uniform(-1.5, 1.5, 3)],
                      1).astype(np.float32)
        yield dict(features=f, coords=c, valid=v,
                   gt_boxes=torch.from_numpy(gt),
                   gt_labels=torch.zeros(3, dtype=torch.int32),
                   gt_mask=torch.ones(3, dtype=torch.bool))


def _setup(total_steps=4, accumulate=1):
    model = init_variables(PointPillars(TINY, device="cpu"), device="cpu",
                           generator=torch.Generator().manual_seed(3))
    opt, _ = make_optimizer(model.parameters(), total_steps,
                            accumulate=accumulate)
    anchors = make_anchors(TINY, device="cpu")
    step = make_train_step(model, opt, TINY, anchors, external_targets=True)

    def prep(batch):
        return prepare_targets(anchors, batch, cfg=TINY, dense=True)

    return model, opt, step, prep


def test_trainer_resume_equals_the_straight_run(tmp_path):
    """Four steps straight, against three steps with a checkpoint, then a
    new model and optimizer restored by ``restore_or`` running the fourth
    on the same batch: parameters, BatchNorm statistics and the optimizer
    state equal bit for bit (the one-cycle schedule's count included).
    The loop logs every 2 steps, saves every 2, keeps 2."""
    batches = list(batch_frames(_frames(1, 8), 2))
    model, opt, step, prep = _setup()
    straight = Trainer(step, prep_fn=prep, log_every=0)
    assert straight.run(model, opt, iter(batches)) == 4

    ckpt = TrainCheckpointer(tmp_path / "run", keep=2)
    logs = []
    model_a, opt_a, step_a, prep_a = _setup()
    tr = Trainer(step_a, prep_fn=prep_a, checkpointer=ckpt, log_every=2,
                 ckpt_every=2, log_fn=logs.append)
    assert tr.run(model_a, opt_a, iter(batches[:3])) == 3
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step == 3
    assert len(logs) == 1 and "total=" in logs[0]

    model_b, opt_b, step_b, prep_b = _setup()
    tr2 = Trainer(step_b, prep_fn=prep_b, checkpointer=ckpt, log_every=0,
                  ckpt_every=0)
    start = tr2.restore_or(model_b, opt_b)
    assert start == 3 and opt_b.count == 3
    assert tr2.run(model_b, opt_b, iter(batches[3:]), start_step=start) == 4
    for (name, want), got in zip(model.state_dict().items(),
                                 model_b.state_dict().values()):
        assert torch.equal(got, want), name
    assert opt_b.count == opt.count == 4
    for p, q in zip(model.parameters(), model_b.parameters()):
        for k in ("m", "v"):
            assert torch.equal(opt.state[p][k], opt_b.state[q][k])
    assert ckpt.all_steps() == [3, 4]


def test_optimizer_state_carries_the_accumulation_phase():
    """``ClippedAdamW`` at accumulate=2 saved after 3 steps (one update
    applied, one gradient waiting) and loaded into a new optimizer: the
    next 3 steps give the straight run's parameters exactly."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(6)]

    def run(params, opt, gs):
        for g in gs:
            params[0].grad = torch.from_numpy(g)
            opt.step()

    p0 = torch.nn.Parameter(torch.from_numpy(
        rng.normal(size=(4, 3)).astype(np.float32)))
    straight = [torch.nn.Parameter(p0.detach().clone())]
    opt, _ = make_optimizer(straight, 6, base_lr=1e-2, accumulate=2)
    run(straight, opt, grads)

    first = [torch.nn.Parameter(p0.detach().clone())]
    opt1, _ = make_optimizer(first, 6, base_lr=1e-2, accumulate=2)
    run(first, opt1, grads[:3])
    saved = opt1.state_dict()
    assert (saved["count"], saved["mini_step"]) == (1, 1)
    second = [torch.nn.Parameter(first[0].detach().clone())]
    opt2, _ = make_optimizer(second, 6, base_lr=1e-2, accumulate=2)
    opt2.load_state_dict(saved)
    run(second, opt2, grads[3:])
    assert torch.equal(second[0], straight[0])
    assert (opt2.count, opt2.mini_step) == (3, 0)


def test_trainer_reads_metrics_only_when_it_logs():
    """Between logs the loop neither reads a metric nor prefetches past
    the last step; ``eval_fn`` runs every ``eval_every`` steps."""
    reads = []

    class Metric:
        def __float__(self):
            reads.append(1)
            return 1.0

    pulled = []

    def source():
        for i in range(10):
            pulled.append(i)
            yield {"x": np.zeros(1)}

    evals = []
    tr = Trainer(lambda batch: {"total": Metric()}, log_every=3,
                 log_fn=lambda s: None, eval_every=2,
                 eval_fn=lambda step, model: evals.append(step) or {"m": 1})
    assert tr.run(None, None, source(), num_steps=5) == 5
    assert len(reads) == 1           # step 3 only
    assert pulled == [0, 1, 2, 3, 4]  # nothing past the fifth step
    assert evals == [2, 4]
    assert [h["step"] for h in tr.history] == [2, 3, 4]


def test_checkpointer_retention_and_existing_steps(tmp_path):
    """``maybe_save`` at its cadence, retention of the newest ``keep``, a
    step that already exists left alone (False), no temporary file left,
    and ``restore(like=...)`` putting tensors where the template's are."""
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    stats = {"mean": torch.zeros(3)}
    opt_state = {"state": {0: {"m": torch.ones(2, 3)}}, "count": 4}
    ckpt = TrainCheckpointer(tmp_path / "run", keep=2)
    for s in (0, 5, 10, 15):
        assert ckpt.maybe_save(s, params, stats, opt_state, every=5)
    assert not ckpt.maybe_save(7, params, stats, opt_state, every=5)
    assert not ckpt.save(15, params, stats, opt_state)
    ckpt.wait()
    assert ckpt.all_steps() == [10, 15] and ckpt.latest_step == 15
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "step_10.pt", "step_15.pt"]
    params["w"] += 1  # the save copied the tensors
    state = ckpt.restore(step=10, like=(params, stats, opt_state))
    assert torch.equal(state["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert state["opt_state"]["count"] == 4
    assert torch.equal(state["opt_state"]["state"][0]["m"], torch.ones(2, 3))
    assert TrainCheckpointer(tmp_path / "empty").restore() is None
    ckpt.close()


def test_ema_matches_jax():
    """``ema_update`` against the JAX package's on the same values: 5
    warm-up steps then 5 at fixed decay, float32, within one ulp of the
    terms' magnitude (~1; XLA:CPU may fuse the update's multiply-add, and
    the sum of two terms of opposite sign can be far smaller than either);
    BatchNorm buffers stay out."""
    rng = np.random.default_rng(2)
    model = torch.nn.BatchNorm1d(4)
    model.weight.data = torch.from_numpy(rng.normal(size=4).astype(
        np.float32))
    ema = ema_init(model)
    assert set(ema) == {"weight", "bias"}
    jema = j_ema_init({k: jnp.array(v.numpy()) for k, v in ema.items()})
    for i in range(10):
        new = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in ema.items()}
        step = i if i < 5 else None
        ema_update(ema, {k: torch.from_numpy(v) for k, v in new.items()},
                   decay=0.99, step=step)
        jema = j_ema_update(jema, {k: jnp.asarray(v) for k, v in new.items()},
                            decay=0.99, step=step)
        for k in ema:
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(jema[k]),
                                       rtol=1.2e-7, atol=1.2e-7, err_msg=k)


def test_init_variables_is_seeded_on_the_cpu():
    a = init_variables(PointPillars(TINY, device="cpu"), device="cpu",
                       generator=torch.Generator().manual_seed(5))
    b = PointPillars(TINY, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


class TestHostPipeline:
    def test_prefetch_order_and_exceptions(self):
        assert list(prefetch(range(10), depth=3)) == list(range(10))

        def boom():
            yield 1
            raise RuntimeError("loader died")

        it = prefetch(boom(), depth=2)
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="loader died"):
            list(it)

    def test_prefetch_overlaps(self):
        def slow_frames():
            for i in range(4):
                time.sleep(0.05)
                yield i

        t0 = time.perf_counter()
        for _ in prefetch(slow_frames(), depth=2):
            time.sleep(0.05)
        assert time.perf_counter() - t0 < 0.35

    def test_prefetch_early_exit_releases_worker(self):
        before = threading.active_count()
        it = prefetch(iter(range(1000)), depth=1)
        assert next(it) == 0
        it.close()
        deadline = time.time() + 3
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before, "worker thread stuck"

    def test_batch_frames(self):
        frames = [dict(a=np.full(3, i), b=(torch.full((2,), float(i)),))
                  for i in range(5)]
        batches = list(batch_frames(frames, 2))
        assert len(batches) == 2
        assert batches[0]["a"].shape == (2, 3)
        assert isinstance(batches[1]["b"][0], torch.Tensor)
        assert batches[1]["b"][0].tolist() == [[2.0, 2.0], [3.0, 3.0]]
        batches = list(batch_frames(frames, 2, drop_last=False))
        assert len(batches) == 3 and batches[2]["a"].shape == (1, 3)

    def test_shard_frames_across_hosts(self):
        frames = list(range(10))
        shards = [list(shard_frames_across_hosts(frames, index=i, count=3))
                  for i in range(3)]
        assert shards == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
        assert list(shard_frames_across_hosts(frames)) == frames


def test_profiler(tmp_path):
    assert profiler.tap_time("t") == 0
    x = torch.ones(3)
    assert profiler.tap_time("t", sync=[x]) > 0
    profiler.tap_arrays()
    y = torch.zeros(7)
    live, _ = profiler.tap_arrays()
    assert any(t is y for t in live)
    del live, y
    _, dead = profiler.tap_arrays()
    assert dead
    with profiler.trace(str(tmp_path / "tr")) as d:
        (torch.ones(8) * 2).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert d == str(tmp_path / "tr")
    params, stats, opt_state = train_state(torch.nn.Linear(2, 2),
                                           torch.optim.SGD([torch.zeros(1)],
                                                           lr=0.1))
    assert set(params) == {"weight", "bias"} and stats == {}


def test_checkpointer_under_thread_switching(tmp_path):
    """Forty saves in a row with keep=3 while the interpreter switches
    threads every microsecond: every writer finishes (wait), the newest
    three steps are on disk and nothing else, and each holds its step."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ckpt = TrainCheckpointer(tmp_path / "run", keep=3)
        for s in range(40):
            assert ckpt.save(s, {"w": torch.full((64,), float(s))}, {}, {})
        ckpt.wait()
    finally:
        sys.setswitchinterval(interval)
    assert ckpt.all_steps() == [37, 38, 39]
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "step_37.pt", "step_38.pt", "step_39.pt"]
    for s in (37, 38, 39):
        assert float(ckpt.restore(step=s)["params"]["w"][0]) == s
