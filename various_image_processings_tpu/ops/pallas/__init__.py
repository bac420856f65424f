"""Pallas-Triton GPU kernels (``backend="triton"``).

Only the bilateral / joint bilateral stencil has one: it is the hottest op
(the 4K filters and the k=2k−1 JBF stage of every bilateral texture filter
iteration).  Every other op runs its XLA path.
"""
