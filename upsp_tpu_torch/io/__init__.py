"""File formats: grids, targets, videos, calibrations, flat files, HDF5.

Copies of the modules of ``upsp_tpu/io/`` that the port reads and writes
with (numpy only), kept at the same relative paths so each names its
counterpart; the port imports nothing of the JAX package.  Unlike
``upsp_tpu/io/__init__.py`` this package re-exports nothing.
"""
