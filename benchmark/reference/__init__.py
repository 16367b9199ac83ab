"""The benchmark's plain reference: scene generators, the ray trace, the
IR deposit and the stream's convolution, in plain PyTorch and NumPy. It
imports nothing of the measured program and takes nothing the program
made; the harness hands it the inputs it drew itself."""
