"""Models of the port: the recsys models (DLRM, Wide & Deep, MIND) for
serving, training and candidate scoring.

* layers — `uniform_init` and the MLP (`nn.Linear` stacks)
* recsys — the stacked embedding table and its lookup (whose gradient is a
           row gradient), the three models as `nn.Module`s, their losses,
           candidate scoring, exact threshold retrieval, and
           `params_from_jax` / `params_to_jax`, which carry weights between
           the port and the JAX package's pytree layout
"""
