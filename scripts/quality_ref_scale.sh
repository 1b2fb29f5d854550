#!/bin/bash
# TRUE reference-scale stage-2: 47k items / 1.37M users — the reference's
# own catalog AND user count, so an epoch is the same ~1787 optimizer
# steps (bs 768) the reference ran. Stage-1 -> stage-2 -> eval (GNN/hybrid
# are measured at 200k scale in quality_xl.sh; the 28M-edge GNN epoch is
# hours on one chip and adds no new parity evidence).
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_ref_scale
WD=$OUT/world
mkdir -p "$WD"
SETS="--set data.root=$WD --set data.num_items=47000 --set data.num_users=1370000 --set data.days=365"

python -m recsys.pipeline.cli gen-data $SETS || exit 1
python -m recsys.pipeline.cli etl $SETS | tee "$OUT/etl.json" || exit 1
timeout 7200 python -m recsys.pipeline.cli train-item $SETS \
  --set simcse.epochs=3 | tee "$OUT/item.json" || exit 1
python -m recsys.pipeline.cli vectorize $SETS || exit 1
timeout 21600 python -m recsys.pipeline.cli train-user $SETS \
  --set user_train.ckpt_every=5 | tee "$OUT/user.json"
timeout 7200 python -m recsys.pipeline.cli eval $SETS | tee "$OUT/eval.json"
echo REF-SCALE-DONE
