"""Measurement programs of the port on the card: the op-latency roofline
of the bench's step (`roofline`) and serial against batched lanes
(`lane_regime`), counterparts of the repo's probes/."""
