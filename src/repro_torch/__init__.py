"""PyTorch/CUDA port of the ``repro`` FL system.

Mirrors ``repro``'s module names so each function has an obvious
counterpart. The paper's synchronous FL loop runs on the dense ``[N, P]``
client plane; its two hot reductions (the eq.-(4) fold and the pairwise
squared-L2 distances behind K-means and the divergence signal) are
hand-written CUDA kernels for Hopper (``repro_torch.kernels``).

Entry point::

    from repro_torch.api import ExperimentSpec, build_experiment
    hist = build_experiment(ExperimentSpec()).run(rounds=3)     # on cuda

Pass ``device="cpu"`` to run the plain PyTorch paths instead.
"""
