"""repro_torch — the PyTorch + CUDA port of the N-list frequent-itemset miner.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``data/``, ``kernels/<name>/{kernel,ops,ref}.py``, ``mining/``,
``fault/``, ``launch/``) and its public names, with a torch ``device`` in
place of the JAX mesh. The hot kernels are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` for Hopper (``sm_90a``) at first use.

    from repro_torch.mining import MineSpec, mine
    res = mine(rows, n_items, MineSpec(algorithm="hprepost", min_sup=0.3))

Entry points run on the CUDA device unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
