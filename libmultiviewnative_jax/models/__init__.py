"""Deconvolution model families.

The reference implements exactly one family — sequential Bayesian
multi-view Richardson-Lucy with optional Tikhonov regularization
(/root/reference/src/multiviewnative.cpp:62, inc/cpu_kernels.h:29-90).
Here that family is a configurable model class plus one new family this
library adds: closed-form multi-view Wiener inversion (a single spectral
solve — useful as an RL initializer or a fast preview).
"""

from .richardson_lucy import RichardsonLucy
from .wiener import wiener_deconvolve, WienerFilter

__all__ = ["RichardsonLucy", "WienerFilter", "wiener_deconvolve"]
