#!/bin/bash
# Warm the persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache) on the CPU: the fast test gate's interpret-mode frame
# programs and the multichip dry run.  Safe to re-run: warm entries are
# cache hits.  GPU programs are cached the first time they compile on the
# card.
set -e
cd "$(dirname "$0")/.."
echo "== fast gate"
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow" -x
echo "== multichip dryrun"
python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
echo "warm done"
