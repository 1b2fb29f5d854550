"""recsys — a JAX retrieval-and-ranking framework.

A from-scratch JAX/XLA re-design of the capabilities of
`DotBlossom/LLM-driven_content-based-feature_recommendation_system`
(see SURVEY.md): LLM-feature-enriched SimCSE item tower, SASRec-style
gated user tower with LogQ-corrected in-batch sampled softmax and
hard-negative mining, LightGCL graph contrastive learning with
magnitude->cosine distillation, ensemble retrieval, DeepFM/DCN reranker,
full-catalog top-k evaluation, serving, and pipeline orchestration.

Design pillars:
  * bf16 compute / fp32 params, everything jit-compiled with static shapes.
  * SPMD over a ``jax.sharding.Mesh`` with (data, model) axes; row-sharded
    embedding tables and item matrix; XLA inserts the collectives.
  * Pure-functional, stateless data transforms (hashing, vocab) so there
    is nothing to race on.
"""

__version__ = "0.1.0"
