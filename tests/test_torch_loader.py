"""The port's batch loader (x_as_supervision_tpu_torch/data/loader.py)
against the JAX package's, the port's Trainer feed (epoch-shuffled, as the
JAX trainer feeds it), the train CLI's --seed -1 and --epoch.

The loaders are compared exactly: the same sample indices in the same
order, and bitwise equal batch arrays, for every seed, epoch, shard count
and drop_last case below.
"""

import json
import os

import numpy as np
import pytest
import torch

from x_as_supervision_tpu.config import apply_overrides as jax_overrides
from x_as_supervision_tpu.data.loader import BatchAssembly as JaxAssembly
from x_as_supervision_tpu.data.loader import BatchLoader as JaxLoader
from x_as_supervision_tpu_torch.config import apply_overrides
from x_as_supervision_tpu_torch.data.loader import BatchAssembly, BatchLoader
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.train import trainer as trainer_mod
from x_as_supervision_tpu_torch.train.factory import flagship_config
from x_as_supervision_tpu_torch.train.trainer import Trainer

NUM_SAMPLES = 11  # not a multiple of the batch: drop_last matters
BATCH = 4
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)


class Tagged:
    """A dataset whose samples carry their index (``sample_id``, an array
    that batches stack, and ``sample_tag``, a string that they list)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def sample(self, i):
        return {**self.dataset.sample(i), "sample_id": np.int64(i),
                "sample_tag": f"s{i}"}


def _epochs(loader_cls, seed, epoch, shards, drop_last):
    ds = Tagged(SyntheticPoseDataset(num_samples=NUM_SAMPLES,
                                     cam_id_list=(0, 1), patch_size=16))
    out = []
    for shard in range(shards):
        loader = loader_cls(ds, BATCH, shuffle=True, num_workers=3,
                            prefetch=2, seed=seed, num_shards=shards,
                            shard_index=shard, drop_last=drop_last)
        out.append((len(loader), list(loader.epoch(epoch))))
    return out


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("epoch", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 7])
def test_loader_matches_jax(seed, epoch, shards, drop_last):
    want = _epochs(JaxLoader, seed, epoch, shards, drop_last)
    got = _epochs(BatchLoader, seed, epoch, shards, drop_last)
    order = np.random.default_rng(seed + epoch).permutation(NUM_SAMPLES)
    steps = NUM_SAMPLES // BATCH + (0 if drop_last else 1)
    for shard, ((n_want, b_want), (n_got, b_got)) in enumerate(zip(want,
                                                                   got)):
        assert n_got == n_want == steps == len(b_got) == len(b_want)
        ids = []
        for bw, bg in zip(b_want, b_got):
            assert sorted(bg) == sorted(bw)
            for k in bw:
                if isinstance(bw[k], list):
                    assert bg[k] == bw[k], k
                else:
                    np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)
            assert bg["sample_tag"] == [f"s{i}" for i in bg["sample_id"]]
            ids.append(bg["sample_id"])
        # this shard's slice of each global batch of the epoch's order
        local = BATCH // shards
        for step, got_ids in enumerate(ids):
            batch = order[step * BATCH:(step + 1) * BATCH]
            np.testing.assert_array_equal(
                got_ids, batch[shard * local:(shard + 1) * local])


def test_an_epoch_stopped_early_ends_its_producer():
    import threading
    import time

    ds = SyntheticPoseDataset(num_samples=40, cam_id_list=(0,),
                              patch_size=16)
    loader = BatchLoader(ds, 2, num_workers=2, prefetch=1)
    before = set(threading.enumerate())
    gen = loader.epoch(0)
    next(gen)
    # the producer (the pool's idle workers stay for the next epoch)
    (producer,) = [t for t in threading.enumerate() if t not in before
                   and not t.name.startswith("ThreadPoolExecutor")]
    time.sleep(1.0)  # time to fill the queue and block on the next put
    gen.close()
    producer.join(timeout=30)
    assert not producer.is_alive()


def test_the_loader_records_each_batchs_production_time():
    """Every batch made is counted, over every epoch, and its seconds
    summed and kept if the least, each batch at least the time of the
    slowest sample in it."""
    import time

    class Slow(SyntheticPoseDataset):
        def sample(self, index):
            time.sleep(0.02)
            return super().sample(index)

    ds = Slow(num_samples=6, cam_id_list=(0,), patch_size=16)
    loader = BatchLoader(ds, 2, num_workers=2, prefetch=1)
    for epoch in range(2):
        assert len(list(loader.epoch(epoch))) == 3
        assert loader.batches_made == 3 * (epoch + 1)
    assert loader.batch_seconds_min >= 0.02
    assert loader.batch_seconds_total >= 0.02 * loader.batches_made


def test_loader_rejects_uneven_shards():
    ds = SyntheticPoseDataset(num_samples=4, patch_size=16)
    with pytest.raises(ValueError, match="divide evenly"):
        BatchLoader(ds, 3, num_shards=2)


def test_batch_assembly_matches_jax():
    ds = SyntheticPoseDataset(num_samples=5, cam_id_list=(0, 2),
                              patch_size=16, seed=3)

    def make(base):
        class DS(base):
            def __len__(self):
                return len(ds)

            def sample(self, i):
                return {**ds.sample(i), "cam_0_img_path": f"p{i}",
                        "cam_0_geodesic_center": np.zeros(2),
                        "name": f"n{i}"}

        return DS()

    want, got = make(JaxAssembly), make(BatchAssembly)
    for fn, args in (("batch", (3, 4)), ("device_batch", (3, 4)),
                     ("batch_from_indices", ([4, 0, 2],))):
        w, g = getattr(want, fn)(*args), getattr(got, fn)(*args)
        assert sorted(g) == sorted(w), fn
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], (fn, k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{fn} {k}")


# ------------------------------------------------------------ the trainer


def _config(num_epochs: int) -> dict:
    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=2, num_epochs=num_epochs,
                               checkpoint_freq=1)
    return cfg


class Recorder:
    """Stands in for the train step: records the sample tags of each batch
    the trainer feeds (the host-only list the loader collates), and returns
    fixed metrics."""

    def __init__(self, monkeypatch):
        self.fed = []
        real = trainer_mod.to_device

        def to_device(batch, device):
            self.fed.append(list(batch["sample_tag"]))
            return real(batch, device)

        def train_step(state, batch, generator, do_disc, do_gen,
                       with_outputs=False):
            state.step += 1
            metrics = {"loss_total": torch.tensor(1.0)}
            return (metrics, {}) if with_outputs else metrics

        monkeypatch.setattr(trainer_mod, "to_device", to_device)
        monkeypatch.setattr(trainer_mod, "train_step", train_step)


def _trainer(num_epochs, save_dir=None, checkpoint_path=None, seed=3):
    ds = Tagged(SyntheticPoseDataset(num_samples=6, cam_id_list=(0, 1),
                                     patch_size=64))
    return Trainer(_config(num_epochs), ds, seed=seed, dtype=torch.float32,
                   device="cpu", save_dir=save_dir,
                   checkpoint_path=checkpoint_path, num_workers=2)


def test_trainer_feeds_the_epoch_shuffled_loader(monkeypatch, tmp_path):
    """3 epochs of 3 steps: each epoch's batches are the JAX loader's
    (BatchLoader(shuffle=True, seed=seed) epoch e, as the JAX trainer
    builds it); a run resumed after epoch 0 feeds epochs 1-2 as the
    straight run does."""
    rec = Recorder(monkeypatch)
    straight = _trainer(3, str(tmp_path / "straight"))
    straight.train(log=lambda _: None)
    assert straight.steps_per_epoch == 3
    want = []
    for epoch in range(3):
        jl = JaxLoader(straight.dataset, 2, shuffle=True, num_workers=2,
                       prefetch=2, seed=3)
        want += [list(b["sample_tag"]) for b in jl.epoch(epoch)]
    assert rec.fed == want
    assert len({tuple(b) for b in want[:3]} ^ {tuple(b) for b in want[3:6]})

    rec.fed.clear()
    first = _trainer(1, str(tmp_path / "first"))
    first.train(log=lambda _: None)
    assert rec.fed == want[:3]
    rec.fed.clear()
    resumed = _trainer(3, str(tmp_path / "resumed"), checkpoint_path=str(
        tmp_path / "first" / "00000_ckpt"))
    assert resumed.epochs_run == 1
    resumed.train(log=lambda _: None)
    assert rec.fed == want[3:]


class _NoState:
    """Stands in for the JAX train state where only the loop runs: empty
    parameter trees, an epoch count, ``replace``."""

    det_params = phys_params = disc_params = det_stats = {}

    def __init__(self, epoch=0):
        self.epoch = epoch

    def replace(self, epoch):
        return _NoState(epoch)


def test_trainer_feeds_what_the_jax_trainer_feeds(monkeypatch, tmp_path):
    """The JAX package's Trainer loop (its state, step, sharding and
    checkpoints stubbed: only its loader and cadence run) and the port's,
    one config, one seed, 3 epochs: the same samples in the same order."""
    import jax.numpy as jnp

    from x_as_supervision_tpu.train import trainer as jax_trainer_mod

    rec = Recorder(monkeypatch)
    _trainer(3, str(tmp_path / "port")).train(log=lambda _: None)

    class JaxTagged(Tagged):
        def device_batch(self, start, n):
            return self.dataset.device_batch(start, n)

    fed = []

    def step(state, batch, rng, do_disc, do_gen, with_outputs):
        fed.append([f"s{i}" for i in np.asarray(batch["sample_id"])])
        return state, {}, {}

    monkeypatch.setattr(jax_trainer_mod, "init_train_state",
                        lambda *a: _NoState())
    monkeypatch.setattr(jax_trainer_mod.M, "replicate_state",
                        lambda s, m: s)
    monkeypatch.setattr(jax_trainer_mod.M, "shard_batch", lambda b, m: b)
    monkeypatch.setattr(jax_trainer_mod.ckpt, "save_checkpoint",
                        lambda *a: "")
    ds = JaxTagged(SyntheticPoseDataset(num_samples=6, cam_id_list=(0, 1),
                                        patch_size=64))
    jt = jax_trainer_mod.Trainer(_config(3), ds, str(tmp_path / "jax"),
                                 seed=3, dtype=jnp.float32, num_workers=2)
    jt.step_fn = step
    jt.train(tb_logger=None)
    assert len(fed) == 9 and rec.fed == fed


def test_seed_minus_one_is_a_time_seed(monkeypatch, tmp_path):
    """--seed -1: the trainer's seed is int(time.time()) % 2**31, the run
    directory is seed_rand_, and two times give two sets of weights (one
    time gives one)."""
    import time as time_mod

    from x_as_supervision_tpu_torch.train.__main__ import main

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_config(1)))

    def run(now, log):
        monkeypatch.setattr(time_mod, "time", lambda: now)
        return main(["--config", str(path), "--synthetic", "--device", "cpu",
                     "--fp32", "--steps", "0", "--worker", "2",
                     "--log_dir", str(tmp_path / log)])

    a, b, c = (run(2**31 + 12345.7, "a"), run(2**31 + 999.2, "b"),
               run(2**31 + 12345.1, "c"))
    assert (a.seed, b.seed, c.seed) == (12345, 999, 12345)
    for t, log in ((a, "a"), (b, "b")):
        (run_dir,) = os.listdir(tmp_path / log)
        assert run_dir.startswith("tiny_seed_rand_")
        assert t.save_dir == str(tmp_path / log / run_dir)
    sa, sb, sc = (t.spec.detector.state_dict() for t in (a, b, c))
    assert not torch.equal(sa["net.backbone.conv1.weight"],
                           sb["net.backbone.conv1.weight"])
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    # a fixed seed is taken as it is, and seeds numpy's global generator
    # as the JAX package's setup_seed does
    d = main(["--config", str(path), "--synthetic", "--device", "cpu",
              "--fp32", "--steps", "0", "--seed", "5", "--worker", "2",
              "--log_dir", str(tmp_path / "d")])
    assert d.seed == 5
    np.random.seed(5)
    want = np.random.random()
    main(["--config", str(path), "--synthetic", "--device", "cpu", "--fp32",
          "--steps", "0", "--seed", "5", "--worker", "2", "--log_dir",
          str(tmp_path / "e")])
    assert np.random.random() == want


@pytest.mark.parametrize("batch_size,epochs", [(None, None), (4, None),
                                               (None, 7), (3, 2)])
def test_apply_overrides_matches_jax(batch_size, epochs):
    cfg = _config(1)
    want = jax_overrides(cfg, batch_size, epochs)
    got = apply_overrides(cfg, batch_size, epochs)
    assert got == want
    assert cfg == _config(1)  # a copy; the input is left as it was


def test_epoch_flag_sets_num_epochs(tmp_path):
    from x_as_supervision_tpu_torch.train.__main__ import main

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_config(1)))
    trainer = main(["--config", str(path), "--synthetic", "--device", "cpu",
                    "--fp32", "--steps", "0", "--seed", "0", "--epoch", "3",
                    "--batch_size", "4", "--worker", "2",
                    "--log_dir", str(tmp_path / "log")])
    assert trainer.num_epochs == 3 and trainer.batch_size == 4
    assert trainer.config["train_params"]["num_epochs"] == 3
