"""Build the native runner (at first use) and print its path:
python -m yololp_tpu_torch.deploy.aoti_cpp"""

from yololp_tpu_torch.deploy.aoti_cpp import build_runner

if __name__ == "__main__":
    print(build_runner())
