"""Tree learner of the port: histograms and their kernels, split search,
the rounds grower, and the integer-level gradient quantization."""
