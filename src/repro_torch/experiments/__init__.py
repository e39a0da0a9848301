"""The paper's experiments on the port (ports of the reference's
``benchmarks/`` scripts and ``examples/cfel_cifar_train.py``, each under
its reference's file name).  Results go to ``common.RESULTS``."""
