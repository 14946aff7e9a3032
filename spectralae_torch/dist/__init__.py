"""Data- and tensor-parallel runtime over :mod:`torch.distributed`.

Port of :mod:`spectralae.dist`.  One process a rank (SPMD): every rank runs
the same function on its own batch shard, and the mesh axes are process
groups (:mod:`spectralae_torch.dist.mesh`); every collective goes through
:mod:`spectralae_torch.dist.collectives`.

- :mod:`~spectralae_torch.dist.multihost`: join the process group
  (:func:`~spectralae_torch.dist.multihost.init_multihost`), the rank's
  index and its batch shard;
- :mod:`~spectralae_torch.dist.mesh`: the ``("data", "model")`` mesh, the
  batch sharding, the parameters sharded over the model axis, the train
  step on both axes and the forward on grid-row slabs;
- :mod:`~spectralae_torch.dist.model_axis`: that step's and that
  forward's bodies, each conv on the rank's slice, and the collectives
  they issue.
"""
