"""PyTorch/CUDA port of mygauhuman_tpu (the SMPL-deformed Gaussian human).

Each module `mygauhuman_torch/<sub>/<name>.py` ports
`mygauhuman_tpu/<sub>/<name>.py`. The package imports `torch` and never
`jax` or `mygauhuman_tpu`. Ops follow the device of their input tensors: a
CUDA tensor runs the hand-written kernel (`csrc/*.cu`), a CPU tensor runs
the plain PyTorch version beside it. Entry points that create tensors take
`device=` and default to `"cuda"`.
"""
