"""Models of the port: the recsys models (DLRM, Wide & Deep, MIND,
BERT4Rec), the LM stack and the GAT.

* layers      — `uniform_init`, the MLP (`nn.Linear` stacks), the norms,
                activations and rotary embedding of the reference
* attention   — GQA and MLA attention (prefill and decode), query-chunked
                and chunked-local softmax attention
* moe         — the grouped, capacity-limited MoE FFN
* transformer — the decoder-only LM: parameters, forward, prefill and
                decode, the training loss, `train_view`, and
                `params_from_jax` / `params_to_jax`
* gnn         — the GAT (full-graph, minibatch and batched-graph regimes,
                their losses) and the host `NeighborSampler`
* recsys      — the stacked embedding table and its lookup (whose gradient
                is a row gradient), the recsys models, their losses,
                candidate scoring, exact threshold retrieval, and
                `params_from_jax` / `params_to_jax`, which carry weights
                between the port and the JAX package's pytree layout
"""
