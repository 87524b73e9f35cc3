"""Deployment clients of the exported model (aoti_cpp/: the native C++
runner of an AOTInductor package)."""
