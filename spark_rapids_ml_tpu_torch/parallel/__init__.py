#
# The device mesh, its collectives and topology, partition metadata, fault
# injection, and the multi-controller layer (context, runner, netplane).
#
