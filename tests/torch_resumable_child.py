"""The port's train CLI under injected faults, for tests/test_torch_resumable.py:

    python tests/torch_resumable_child.py -m <CLI module> <CLI args>

runs the CLI module as ``python -m`` would, on a synthetic fixture cut to
two batches an epoch (the CLI's fixture holds at least 64 samples), with
every TensorBoard event flushed as it is written (so the watchdog's
heartbeat is each step, not each 8 KB) and torch._dynamo imported first
(torch imports it at the first optimizer step, seconds without a write).

XAS_TEST_FAULTS lists a fault for each attempt, comma-separated (empty:
none); XAS_TEST_ATTEMPTS names a file counting the attempts so far. The
attempt's fault acts once its first checkpoint is saved:

  crash  dies (exit 3) in the middle of the next save: the checkpoint's
         directory made and ``state.pt.tmp`` written, not yet renamed;
  stop   starts two ``sleep`` processes, one in its own process group and
         one in a session of its own, writes their pids to
         ``<attempts file>.pids`` and stops itself (SIGSTOP): a wedged
         trainer whose processes the driver must all end.
"""

from __future__ import annotations

import os
import runpy
import signal
import subprocess
import sys


def _shrink_fixture() -> None:
    from x_as_supervision_tpu_torch.data import synthetic

    def two_batches(config):
        tp = config["train_params"]
        return synthetic.SyntheticPoseDataset(
            num_samples=2 * tp["batch_size"],
            cam_id_list=config["dataset_params"]["cam_id_list"],
            patch_size=tp.get("patch_width", 256),
            rect_3d_width=tp.get("rect_3d_width", 2000))

    synthetic.synthetic_dataset = two_batches


def _flush_events() -> None:
    from x_as_supervision_tpu_torch.train.logging import SummaryWriter

    write = SummaryWriter._write

    def write_and_flush(self, event):
        write(self, event)
        self.flush()

    SummaryWriter._write = write_and_flush


def _inject(fault: str, pids_file: str) -> None:
    import torch

    from x_as_supervision_tpu_torch.train import checkpoint as ckpt

    save = ckpt.save_checkpoint
    saves = []

    def faulty_save(save_dir, epoch, state):
        if saves and fault == "crash":
            path = ckpt.ckpt_path(save_dir, epoch)
            os.makedirs(path, exist_ok=True)
            torch.save(ckpt.state_dict(state),
                       os.path.join(path, ckpt.STATE_FILE + ".tmp"))
            os._exit(3)
        path = save(save_dir, epoch, state)
        saves.append(path)
        if fault == "stop":
            print(f"checkpoint saved: {path}", flush=True)
            group = subprocess.Popen(["sleep", "600"])
            session = subprocess.Popen(["sleep", "600"],
                                       start_new_session=True)
            with open(pids_file, "w") as f:
                f.write(f"{group.pid} {session.pid}")
            os.kill(os.getpid(), signal.SIGSTOP)
        return path

    ckpt.save_checkpoint = faulty_save


def _this_attempts_fault() -> None:
    counter = os.environ.get("XAS_TEST_ATTEMPTS")
    if not counter:
        return
    done = int(open(counter).read()) if os.path.exists(counter) else 0
    with open(counter, "w") as f:
        f.write(str(done + 1))
    faults = [f for f in os.environ.get("XAS_TEST_FAULTS", "").split(",")
              if f]
    if done < len(faults):
        _inject(faults[done], counter + ".pids")


def main() -> None:
    if sys.argv[1] != "-m":
        raise SystemExit("usage: torch_resumable_child.py -m <module> ...")
    module, args = sys.argv[2], sys.argv[3:]
    import torch._dynamo  # noqa: F401

    _shrink_fixture()
    _flush_events()
    _this_attempts_fault()
    sys.argv = [module, *args]
    runpy.run_module(module, run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
