"""Published peaks of the cards the benchmark reads rooflines against, by
`torch.cuda.get_device_name()`.  NVIDIA's H100 data sheet, SXM part: 3.35 TB/s
of HBM3, at its full 700 W power limit.  A card missing here gets no
roofline share (the metric reads nothing)."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
