"""Training and test data: MATLAB-exact degradation, HSI datasets, the
batch loader and the device-resident scene cache."""
