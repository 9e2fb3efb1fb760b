#!/bin/bash
# One-dataset end-to-end example — the reference's run_an_example.sh analog
# (it downloads SVHN and runs ./Tahoe MODEL DATA; no egress here, so the
# fixture is synthesized in the same text formats first).
#
# Usage: bash scripts/run_an_example.sh [shape] [outdir]
set -e
cd "$(dirname "$0")/.."
SHAPE=${1:-susy_like}
DIR=${2:-fixtures}
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
python scripts/make_fixtures.py "$DIR" --shape "$SHAPE" --rows 4000
python -m tahoe_tpu.cli "$DIR/model_$SHAPE.txt" "$DIR/data_$SHAPE.txt" \
  --epochs 8 --warmup 2
