"""bwa_flow_tpu — a JAX re-architecture of BWA-MEM for an accelerator.

A from-scratch JAX/XLA framework with the capabilities of
falcon-computing/bwa-flow (an FPGA-accelerated BWA-MEM pipeline): batched
SMEM seeding and banded Smith-Waterman seed extension run on the device
(an NVIDIA GPU), with a host-side dataflow pipeline for FASTQ ingest,
chaining, pairing, SAM/BAM emission, duplicate marking and sorted output.

Design stance (not a port): the reference decomposes the per-read aligner
into fixed-shape batched stages with device offload of the two hot kernels
and strict output equivalence (see SURVEY.md). Here the device kernels are
XLA programs over a device-resident FM-index, the host pipeline is a
thread/queue dataflow, and multi-device runs replicate the index per
device or run one process per device instead of MPI ranks.
"""

import jax

# Genome coordinates for human-scale references exceed 2^31 (seq_len =
# 2*l_pac ~ 6.2e9), so interval arithmetic needs 64-bit integers. Enable
# x64 once at package import; hot kernels still use int32 internally when
# the genome fits.
jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
