"""The training input thread stops when its consumer does.

``data_loader`` collates on a background thread that fills a bounded
queue.  A consumer that stops early (``Trainer`` at ``max_steps``, or a
caller that closes ``Trainer.batches()``) must leave no thread behind: the
thread checks a stop event between batches and while it waits on the full
queue, and the generator sets that event when it is closed.
"""

import json
import threading
import time

import pytest
import torch

from vispeech_tpu_torch.config import load_config
from vispeech_tpu_torch.data.dataset import (LOADER_THREAD, BucketSampler, FilelistDataset,
                                             data_loader)
from vispeech_tpu_torch.data.synthetic import write_synthetic_dataset
from vispeech_tpu_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HOP = 8
CONFIG = {   # tests/test_torch_train.py's tiny configuration
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False, "log_interval": 1,
              "eval_interval": 100},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": HOP, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}


def _config(root, n_utts=6):
    tr, va, data_root = write_synthetic_dataset(str(root), sr=8000, hop=HOP, n_utts=n_utts,
                                                n_phones=5, dur_range=(2, 4))
    cfg = json.loads(json.dumps(CONFIG))
    cfg["train"]["save_dir"] = str(root / "run")
    cfg["data"].update(training_files=tr, validation_files=va)
    path = root / "config.json"
    path.write_text(json.dumps(cfg))
    return load_config(str(path)), data_root


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == LOADER_THREAD and t.is_alive()]


def _joined(timeout=5.0):
    """The loader threads left after ``timeout`` seconds of joining."""
    deadline = time.monotonic() + timeout
    for t in _loader_threads():
        t.join(max(deadline - time.monotonic(), 0.0))
    return _loader_threads()


@pytest.fixture
def corpus(tmp_path):
    assert not _joined(), "a loader thread was alive before the test"
    return _config(tmp_path, n_utts=40)


def test_trainer_leaves_no_loader_thread(corpus):
    cfg, data_root = corpus
    tr = Trainer(cfg, data_root=data_root, device="cpu")
    tr.train(max_steps=1)
    assert tr.global_step == 1
    assert not _joined()
    tr.train(max_steps=2)   # a second call starts and stops its own thread
    assert tr.global_step == 2 and not _joined()


def test_closing_the_batches_stops_the_thread(corpus):
    """A consumer that takes one batch while the worker fills the queue
    to its bound, and then closes the pipeline."""
    cfg, data_root = corpus
    tr = Trainer(cfg, data_root=data_root, device="cpu")
    batches = tr.batches()
    epoch, batch = next(batches)
    assert epoch == 0 and batch["wav"].dtype == torch.int16
    assert _loader_threads()
    time.sleep(0.2)   # the worker is now blocked on the full queue
    batches.close()
    assert not _joined()


@pytest.mark.parametrize("prefetch", [1, 4])
def test_abandoned_loader_ends_and_a_finished_one_too(corpus, prefetch):
    cfg, data_root = corpus
    ds = FilelistDataset(cfg.data.training_files, cfg.data, data_root)
    sampler = BucketSampler(ds.lengths, 1, seed=0)
    every = list(data_loader(ds, sampler, 0, prefetch=prefetch))
    assert len(every) == len(sampler) and not _joined()
    gen = data_loader(ds, sampler, 0, prefetch=prefetch)
    first = next(gen)
    torch.testing.assert_close(first["wav"], every[0]["wav"])
    gen.close()
    assert not _joined()


def test_worker_failure_is_raised_and_the_thread_ends(corpus, monkeypatch):
    from vispeech_tpu_torch.data import dataset

    cfg, data_root = corpus
    ds = FilelistDataset(cfg.data.training_files, cfg.data, data_root)
    sampler = BucketSampler(ds.lengths, 1, seed=0)

    def broken(*args, **kwargs):
        raise OSError("unreadable wav")

    monkeypatch.setattr(dataset, "collate", broken)
    with pytest.raises(OSError, match="unreadable wav"):
        next(data_loader(ds, sampler, 0))
    assert not _joined()
