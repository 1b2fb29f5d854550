#!/bin/bash
# Round-4 headline world: the H&M shape (105k items / 1.37M users / 365
# days / repeat_prob=0.10 — identical to round 3's quality_hm world, same
# seed) PLUS the v4 realism knob `data.name_style_words=2`: each latent
# micro-style cluster signs its product names with style-vocabulary words,
# the regime real H&M names are in ("Skinny Regular Denim") and the one
# where content/text actually carries retrievable signal (VERDICT r3
# missing #5 / next-round item 2). CPU-only data phase: gen-data + etl.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_hm_v4
WD=$OUT/world
mkdir -p "$WD"
SETS="--set data.root=$WD --set data.num_items=105000 --set data.num_users=1370000 \
 --set data.days=365 --set data.repeat_prob=0.10 --set data.name_style_words=2"

# tmp-then-mv so a failed/partial stage never masquerades as done on rerun
# (ADVICE r3: tee left partial stage JSONs behind on timeout)
stage() {  # stage <name> <cmd...>
  local name=$1; shift
  if [ -s "$OUT/$name.json" ]; then echo "skip $name (done)"; return 0; fi
  JAX_PLATFORMS=cpu python -m recsys.pipeline.cli "$@" $SETS \
    > "$OUT/$name.json.tmp" 2> >(tail -40 > "$OUT/$name.stderr") \
    && mv "$OUT/$name.json.tmp" "$OUT/$name.json" \
    || { rm -f "$OUT/$name.json.tmp"; echo "V4-DATA-FAILED: $name"; exit 1; }
}

stage gen gen-data
stage etl etl
echo V4-DATA-DONE
