"""Device ops of the port: mod-q and limb arithmetic, the limb NTT and
its CUDA kernels."""
