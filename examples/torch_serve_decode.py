"""Serving example on the PyTorch/CUDA port: batched greedy decoding with a
KV cache (reduced gemma), on the GPU through the port's kernels.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu] [flags]

The flags after the script's name follow its defaults, so a later one wins;
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
import sys

from repro_torch.launch.serve import main

DEFAULTS = ["--arch", "gemma-7b", "--reduced", "--batch", "4", "--prompt-len", "8",
            "--tokens", "24"]

if __name__ == "__main__":
    main(DEFAULTS + sys.argv[1:])
