"""Batched serving demo on the PyTorch/CUDA port: greedy generation with
KV caches (port of examples/serve_demo.py).

    PYTHONPATH=src python examples/serve_demo_torch.py --arch zamba2-7b
(runs the reduced config; --full selects the paper-exact config; with no
--device it runs on the card and raises without one, --device cpu runs the
plain PyTorch path)
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
