"""The port's benchmarks: estimates of the cost model held against runs on
the card (counterparts of the reference's ``benchmarks/``)."""
