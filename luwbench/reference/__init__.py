"""The benchmark's plain reference: plain torch and numpy, no kernels.

Frozen copies of the port's plain versions (the stream-collide step, the VK
inlet, the averaging pass, the derived turbulence fields, the VTK reader)
and of its deck-to-case set-up, so that later changes to the program
cannot move the yardstick.  Nothing here imports the program, the JAX
package or JAX; `setup` works a case's tables out again from the deck's
raw inputs and `follow` steps the reference from given DDFs.
"""
