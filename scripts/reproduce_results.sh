#!/bin/bash
# Reproduce every RESULTS.md table from scratch. Each script is standalone,
# idempotent-ish (re-runs regenerate worlds), and tees its per-stage JSON
# into artifacts/<campaign>/ — the committed summary JSONs the tables cite.
#
#   bench.py                      headline throughput anchors (JSON lines)
#   quality_ablation.sh           loss-zoo ablation (small world)
#   quality_mid_diag.sh           v3 mid world attribution table
#   quality_text_pretrain_ab.sh   hash vs corpus-pretrained text encoder
#   quality_xl.sh                 47k-item reference-catalog-scale table
#   quality_hm_shape.sh           THE headline: real H&M shape (105k/1.37M)
#   knn_purity.py <world>         stage-1 purity metric for any world
#   bench_scaling.py              DP scaling efficiency (needs multi-chip)
#
# Training stages run on the GPU when JAX sees one; with
# JAX_PLATFORMS=cpu everything still runs, just slower.
set -e
cd "$(dirname "$0")/.."
python bench.py
bash scripts/quality_text_pretrain_ab.sh
bash scripts/quality_mid_diag.sh
bash scripts/quality_xl.sh
bash scripts/quality_hm_shape.sh
