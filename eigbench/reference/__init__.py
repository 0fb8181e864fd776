"""The benchmark's yardstick: the plain float64 reference, the comparison
that decides ``correct``, and the frozen generators' assembly and metric
arithmetic."""
