"""Host I/O of the v1.0 driver: the TIFF codec, recordings and label
TIFFs, the results tree, and the volume prefetcher."""
