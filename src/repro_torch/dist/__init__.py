"""Distribution outside the model graph: the collectives of a mesh's
axes under autograd (``collectives``) and pipeline parallelism
(``pipeline``)."""
