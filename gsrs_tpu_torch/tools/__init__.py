"""The JAX package's user tools (``tools/`` at the repository root),
ported: one module each, named after its counterpart, with its flags,
its function names and its JSON keys, built from the port's own config,
loaders, models, trainers and checkpoints.

    python -m gsrs_tpu_torch.tools.eval_checkpoint --checkpoint_dir CK --dataset NAME
    python -m gsrs_tpu_torch.tools.bench_serving --checkpoint_dir CK --dataset_dir DS
    python -m gsrs_tpu_torch.tools.bench_eval [--checkpoint_dir CK] [--dataset_dir DS]
    python -m gsrs_tpu_torch.tools.visualize curves|gates --checkpoint_dir CK ...
    python -m gsrs_tpu_torch.tools.compute_ppr --dataset_dir DS --out ppr.npy
    python -m gsrs_tpu_torch.tools.bench_spmm_modes [--dataset_dir DS] [--tiled 64:2048]
    python -m gsrs_tpu_torch.tools.bench_seq [--epochs 3]
    python -m gsrs_tpu_torch.tools.bench_scaling --devices 1 2 4 [--dist_backend gloo]
    python -m gsrs_tpu_torch.tools.sweep_xsimgcl --dataset NAME [--lambdas 0.05 0.1 0.2]
    python -m gsrs_tpu_torch.tools.profile_epoch --dataset NAME --trace_dir TRACE [--eval]
    python -m gsrs_tpu_torch.tools.bench_scale_standin [--spmm ell hybrid] [--batch 2048 8192]
    python -m gsrs_tpu_torch.tools.bench_seq_markov [--epochs 60]

Each runs on ``cuda:0`` and raises when there is no card, unless
``--device cpu`` is given (``compute_ppr`` runs on the host;
``bench_scaling`` takes ``--device cuda|cpu``). A row that
ran a kernel carries the kernels' launch counts over its work
(`gsrs_tpu_torch.kernels.launch_counts`). No tool catches a failure and
carries on."""
