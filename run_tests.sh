#!/bin/bash
# CPU test runner: JAX_PLATFORMS=cpu; tests/conftest.py adds an 8-device
# virtual mesh and float64.  Tests marked `gpu` skip here (chip_smoke.py
# runs them on a GPU).
cd "$(dirname "$0")"
if [ $# -eq 0 ]; then set -- tests/ -x -q; fi
exec env PYTHONPATH="$(pwd)" JAX_PLATFORMS=cpu python -m pytest "$@"
