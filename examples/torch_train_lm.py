"""Training example on the PyTorch/CUDA port: a few hundred steps of a
reduced qwen2.5-3b with checkpointing and auto-resume, on the GPU through
the port's kernels.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

The flags after the script's name follow its defaults, so a later one wins;
``--device cpu`` runs the kernels' plain versions on the CPU.  A run resumes
from the newest checkpoint under ``--ckpt-dir`` (default
``$TMPDIR/repro_ckpt``): give a fresh directory for a fresh run.
"""
import sys

from repro_torch.launch.train import main

DEFAULTS = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "300", "--batch", "8",
            "--seq", "128", "--microbatches", "2", "--save-every", "100"]

if __name__ == "__main__":
    main(DEFAULTS + sys.argv[1:])
