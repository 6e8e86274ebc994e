"""The one engine-selection policy behind every ``algorithm='auto'``.

Every driver (in-core, prepared, interleaved, streamed chunks, mesh
blocks) resolves 'auto' here, from the extent it will really transform
and the backend it runs on.

  * CPU: the dense-DFT engine (``core.dft``, batched einsums) up to 256
    per axis, XLA's FFT above.
  * GPU: ``fft`` everywhere — XLA lowers it to cuFFT.  The dense DFT runs
    its float32 einsums outside the tensor cores at 'highest' precision;
    a backend gets a ``dft`` range here only once a chip measurement
    shows ``dft`` ahead for that class of shapes.
  * any other backend: ``fft``.
"""

from __future__ import annotations

import jax

# Largest per-axis extent at which 'auto' picks the dense-DFT engine, by
# backend.  Backends not listed never pick it.
DFT_MAX_AXIS = {"cpu": 256}


def resolve_algorithm(algorithm: str, spatial_shape, backend: str = None) -> str:
    """The engine ``algorithm`` means for a transform of ``spatial_shape``
    on ``backend`` (default: JAX's default backend).  Anything but 'auto'
    is returned unchanged."""
    if algorithm != "auto":
        return algorithm
    backend = backend or jax.default_backend()
    limit = DFT_MAX_AXIS.get(backend, 0)
    return "dft" if max(int(s) for s in spatial_shape) <= limit else "fft"
