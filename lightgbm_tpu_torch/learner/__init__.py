"""Tree learner of the port: histograms and their kernels, split search,
the rounds and permuted growers, the integer-level gradient quantization
and the percentile leaf refit."""
