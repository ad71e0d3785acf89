"""Models of the port: the recsys serving path (DLRM, Wide & Deep, MIND).

* layers — `uniform_init` and the MLP (`nn.Linear` stacks)
* recsys — the stacked embedding table, the three models as `nn.Module`s,
           candidate scoring, exact threshold retrieval, and
           `params_from_jax`, which carries the JAX package's weights over
"""
