"""Entry points of the port: `serve` (batched greedy decoding)."""
