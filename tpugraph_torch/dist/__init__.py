"""The edge-partitioned distributed trainer (counterpart of
``tpugraph/dist/``) over ``torch.distributed``: ``mesh.py`` (the process
group, shards to ranks), ``halo.py`` (the halo-exchange SpMM on the hand
kernels), ``ring.py`` (ring mining and eval), ``trainer.py``
(``fit_distributed``) and ``mp_worker.py`` (the multi-process tests'
spawn entries)."""
