#
# Partition metadata; the multi-device runtime waits for a later slice.
#
