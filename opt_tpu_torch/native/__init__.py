"""The C API of native/include/OptTpu.h over the port: its C++ source, a C
client and the script that builds them (``build.py``)."""
