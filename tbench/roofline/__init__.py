"""Frozen yardstick of the kernels' and the iterations' work: bytes and
operations computed from shapes (:mod:`tbench.roofline.counts`) against
the published peaks of one NVIDIA H100 SXM (:mod:`tbench.roofline.peaks`).
A later change that replaces a kernel is measured against the same work."""
