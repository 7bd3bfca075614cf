"""CLI: ``python -m su2_tpu <config.cfg> [niter]`` (SU2_CFD equivalent).

``SU2_TPU_PLATFORM=cpu`` forces the JAX platform before backend init —
useful for CPU verification runs on a host with an accelerator.
"""

import os

_plat = os.environ.get("SU2_TPU_PLATFORM")
if _plat:
    import jax

    jax.config.update("jax_platforms", _plat)

from su2_tpu.driver import main

raise SystemExit(main())
