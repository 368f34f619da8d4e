#!/usr/bin/env bash
# CI entry point of the PyTorch port: the analysis gate, its mutation
# check, the port's tests and the serving smokes.
#
#   scripts/ci_torch.sh           # on the CPU (--device cpu throughout)
#   scripts/ci_torch.sh --card    # the same on the card, then chip_smoke.py
#
# On the card the port's tests are the card-only file, run without
# tests/conftest.py (it imports JAX, which a card machine need not have);
# the parity tests against the JAX package run on the CPU.
#
# The serving smokes drive the real serve driver end to end; its
# no-rebuild check makes it a hard failure if a steady-state request
# builds, loads or prepares anything. The JAX package's ci.sh also runs its
# bench smokes (load, merged sweep, sanitized, distributed, index,
# metrics); the port has no bench harness until ROADMAP item A5, so they
# are left out here.
set -euo pipefail
cd "$(dirname "$0")/.."

DEVICE=cpu
CARD=0
for arg in "$@"; do
  case "$arg" in
    --card) DEVICE=cuda; CARD=1 ;;
    *) echo "usage: $0 [--card]" >&2; exit 2 ;;
  esac
done

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

echo "[ci_torch] static analysis gate (contract prover + sync/dtype linter vs baseline)"
timeout 300 python -m repro_torch.analysis --device "$DEVICE"

echo "[ci_torch] analysis mutation check (seeded bugs must each produce a new finding)"
timeout 300 python scripts/mutation_check_torch.py --device "$DEVICE"

if [ "$CARD" = 1 ]; then
  echo "[ci_torch] the port's card tests"
  python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py
else
  echo "[ci_torch] the port's tests (parity with the JAX package)"
  python -m pytest -q -p xdist -n 6 --dist loadfile tests/test_torch_*.py
fi

echo "[ci_torch] serve smoke (steady state must build nothing)"
timeout 120 python -m repro_torch.launch.serve --arch selfjoin \
  --device "$DEVICE" --requests 4

echo "[ci_torch] serve smoke under REPRO_TORCH_SANITIZE=1 (kernel invariants must hold)"
REPRO_TORCH_SANITIZE=1 timeout 120 python -m repro_torch.launch.serve \
  --arch selfjoin --device "$DEVICE" --requests 4

echo "[ci_torch] batching serve smoke (admission queue + coalesced launches)"
timeout 180 python -m repro_torch.launch.serve --arch selfjoin \
  --device "$DEVICE" --requests 8 --batching --request-batch 64 \
  --max-batch 512

echo "[ci_torch] reindex smoke (a snapshot swap under load must not trip the no-rebuild check)"
timeout 180 python -m repro_torch.launch.serve --arch selfjoin \
  --device "$DEVICE" --requests 8 --reindex

if [ "$CARD" = 1 ]; then
  echo "[ci_torch] chip smoke"
  python3 chip_smoke.py
fi

echo "[ci_torch] OK"
