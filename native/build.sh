#!/bin/sh
# Build libdddmr_host.so next to this script from dddmr_host.cpp. The
# library is a build product (not committed); the Python bindings
# (dddmr_navigation_tpu/io/native.py) run this on first use.
set -e
cd "$(dirname "$0")"
tmp="libdddmr_host.so.tmp.$$"
trap 'rm -f "$tmp"' EXIT
g++ -O3 -std=c++17 -fPIC -shared -o "$tmp" dddmr_host.cpp -pthread
mv -f "$tmp" libdddmr_host.so   # atomic: concurrent builders never see half a file
echo "built $(pwd)/libdddmr_host.so"
