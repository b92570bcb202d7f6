"""Operation and byte counts, frozen with the benchmark: the formulas a
roofline share or an MFU divides by.  Each function names its source."""
