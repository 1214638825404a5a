"""Subprocess worker of tests/test_torch_parallel_train.py and
tests/test_torch_parallel_ckpt.py: one "host" of a multi-host job.

argv: process_id num_processes port out_dir mode. The host joins the job
at 127.0.0.1:port with two gloo ranks on the CPU
(``parallel/multihost.py:run_multihost``).

- mode "steps": one CE train step of the tiny config over the pod mesh
  as dp = 4 and as dp 2 x tp 2 (``pod_mesh(tp)``); global rank 0 writes
  the losses and gathered gradients to out_dir/result.pkl.
- mode "cli": ``train --multihost`` with one rank a host; only process 0
  may write metrics.csv.
"""

import os
import pickle
import sys

import torch


def _steps(out_dir):
    from visiontransformer_tpu_torch.parallel import launch
    from visiontransformer_tpu_torch.parallel.multihost import pod_mesh
    from visiontransformer_tpu_torch.train.trainer import Trainer

    import torch_parallel_ranks as R

    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
        params = pickle.load(f)
    result = {}
    for key, tp in (("dp", 1), ("tp2", 2)):
        mesh, _ = pod_mesh(tp=tp)
        trainer = Trainer(R.seg_cfg(), R.train_cfg(), device="cpu",
                          mesh=mesh)
        state = trainer.init_state(params)
        state, metrics = trainer.train_step(state, R.ce_batch(), seed=0)
        grads = trainer.plan.gathered(state.model, lambda p: p.grad)
        if launch.is_primary():
            result[key] = {"losses": [float(metrics["loss"])],
                           "grads": {k: v.numpy() for k, v in grads.items()},
                           "plan": trainer.plan.describe()}
    if launch.is_primary():
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
    return 0


def main():
    from visiontransformer_tpu_torch.parallel.multihost import run_multihost

    pid, nproc, port, out_dir, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
    coordinator = f"127.0.0.1:{port}"
    if mode == "steps":
        run_multihost(_steps, (out_dir,), coordinator=coordinator,
                      num_processes=nproc, process_id=pid, local_ranks=2,
                      device_type="cpu")
    else:
        from visiontransformer_tpu_torch.cli import main as cli_main

        torch.set_num_threads(1)
        rc = cli_main([
            "train", "--data", os.path.join(out_dir, "data"),
            "--config", "P16H512A8", "--image-size", "32",
            "--batch-size", "4", "--accumulate", "1", "--max-epochs", "1",
            "--no-split", "--device", "cpu",
            "--logs", os.path.join(out_dir, f"logs{pid}"),
            "--ckpt-dir", os.path.join(out_dir, "ckpt_shared"),
            "--multihost", "--coordinator", coordinator,
            "--num-processes", str(nproc), "--process-id", str(pid)])
        assert rc == 0
    print(f"[proc {pid}] {mode} done", flush=True)


if __name__ == "__main__":
    main()
