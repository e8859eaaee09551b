#!/bin/bash
# Test runner: the suite on the CPU (virtual 8-device mesh).
cd "$(dirname "$0")/.."
exec env JAX_PLATFORMS=cpu python -m pytest tests/ "$@"
