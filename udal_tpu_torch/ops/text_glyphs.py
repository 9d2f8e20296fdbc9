"""Glyph coverage of cv2 5.0's ``FONT_HERSHEY_SIMPLEX`` at thickness 1.

Recorded from ``cv2.putText`` on a machine with cv2 5.0.0 (default line
type) by ``measure_glyphs`` in ``tests/test_torch_visualize.py``, whose test
regenerates this table and holds it equal; run that file as a script to
print it again. Each of the 95 printable ASCII characters (``" "`` (32) to
``"~"`` (126)) at the two scales the drawing code uses (boxes' labels at
0.4, contact sheets' captions at 0.45) is a uint8 coverage map of
``BOX`` = (rows, columns) pixels, drawn white on black at the text origin
(x, y): the map's row 0 is the image's row y − ``ROW0``, its column 0 the
image's column x − ``COL0``. cv2 5.0 draws this font from an antialiased
outline font, not from Hershey strokes, and at these scales each glyph's
coverage is the same at every whole-pixel position, so a string is its
glyphs composited in order (``ops.cv_ops.put_text``). The maps are stored
zlib-compressed and base64-encoded, [95, rows, columns] a scale.
"""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

FIRST_CHAR = 32
NUM_CHARS = 95
ROW0, COL0 = 14, 2
BOX = (18, 16)

_ENCODED = {
    0.4: (
        "eNrtnQdYFNf2wM/uwi4dFASUIisgYEGxR/FpNJJYMCpiIaLYEvRJ4t9nIbFEY4kFfbZnYqLGl4ifsQWjUQwhYiiK"
        "oBjgqYhSpJeFRWApLux/lidzz9nEfDEv0cFkvs/l++3euTNz5txzzzm3CPDX8WwPST/Kdg2/L3dUUTaeKCbs1dRe"
        "0PKxG9dtKOaxt5afJPcfHbgHs76bhcOfW6Pkq2DGywwNZnxqeGqMpBWt8qor8tUF61iBI+PECqYTEpMkL490E1Er"
        "T8ttyi2rzh3CF+hwFxZsQpezngUjvQQlAH8DgjbFIzDuyo8sijHl0VXVEWSpf+fZTT0IQIzayOKKuIVWuAJD/wgl"
        "q9G1B/cRFsHzlAJ3sL68i2fR2hKF6oQFOl+c04Xebxfx85SWWS/tPfVsxc63Dh8EWPevVl64GDLB55qslae+L/vR"
        "7i57AtnBr6f+MLG9CNW4dcfui9dMePSNN7oNm/xb0emug146bJ7YylGjAVZHX5CRm9ITkDrZj7XHOKroaOEwxJ8v"
        "gdB9iP/+nWuqHza4BY0B0NmVb45XDkQdEoeH8NXdFxme/1LBX8K90gH61icyASwtzsl788wBVqGonbDsM+Wxtyh7"
        "RVPWd3vxDfAa8owWWZssMQecpMX3vUP5y+mUL7xO+dxEyuFvUA5bSXl0vIi+gejLLuQL2XDrZygd0eah9IsFBYPp"
        "FwsPUu55h7J1OWWjR/QBTevp77YllF+6QXnjdnJ/4Xmdyc9jnrODtMUGk8v6jP/zxcq2u/msNy4Qta7YGHN7SYc/"
        "uYu9SecFpsrx65ZI0lwkrAcOyc9vLMqPeGL5n+GVFn+FMczdnG1KG1uJlPDrq1+0AE4iwf6bh0qlSvlLDX7zYTHH"
        "hPoPze6Cu8cu1KCIMnoSfvUyLX5mCsHOefqEP1xLe+PCToQDj9Parg4n2Deddn573hSatJx8e+NbXKaO11yXMP+x"
        "cTRcq2cS8lVI+uw4vpPnWTfhU9dt/2bi+LH9aQhjPFK1yheiNrNwRqkxHlWP4t8JmrpqanPai4UloO6kg5d82ByK"
        "OTI2jvAw/dOh9PynYz1pxEopkkCphju2CNgiOPh6YP2ZWRGpOMruX085Djo+8mTR+Twx9x1xMUW703CLE32cjR08"
        "0f4cJ4IF7lIpu2B/rXg0S4UrnkHe3MEyHpLYhIR7TR7EX74bQgL+65tJBfsffTYac6fec2t8mD3WCufUVtbelG7g"
        "VhHAir9XWa7cLMEStBIJTES9SQAPMzU7iTUvOINZL37edsxrIgDzoLwOhD9Tq1SPmjPY6YaGhnv3Up9n2zYhNy9O"
        "fQYje3AwKyEh3pzx+UBaPmXaSNLdFRUcz4pE2ZuBZmB0O5hp0xju49gG1huoR0CPch/0NgpLy5eRK1gKTH8M+1M+"
        "coJ20HnEHXB+eHYmDgguZ4edz2cp6T6POnLtiaWsfYq5j7Wsjzd9OFNkf3ceO39wemXJRiIRM0HJ5yWt/TFj7su1"
        "5OTkJpqyGFhlRjMWuwl2rO9KeO03BKVFrxGecYc+f0ywsD1aZ18vbB4/LDqa9r0hj+YNjqCXypJostrBYJ2HfLyl"
        "jzJqL6DmWr60u1/hJJ6DrmgzGF/wPKSqB1hcW8FO+Iciu+wTA2KfheX/OI8n9mRLRWTxcXaHfeu7gGX+NJY9S+c+"
        "Ij7g2a1+ADiXo4zIPGVm4yWsIXrBFY74Ah0KqT9+5MCLFD9ZvkeSjeCe83Txk+kMGr97Nnu+WOF6KE1+GmS/9nQV"
        "TLej8tbac3T0+qzNicQtknjLi0rmY2/wYqwz/nlDFg1+DbbnjKLVDcvaRb8w2/oC6Y/50mXLls1CvCI0NHTOk8u3"
        "W79hw4ZFqH0FL1iwwP/FkUePz+lwlH5Yrg8tMfTev+iAbN86HG+I3y7G4jOPvuREvPN3xMIWgN6QcdgCWFy/db56"
        "POPVSSJYhRJCnlxrOkAHOBZn25LmWN+D/Dw7mV5Q7k151bW2pTFeB+Mv7mIp9Enpo9o5+T8Y0CrO3A6O62dOHxjb"
        "6l6ehJSAU+dE2Y9HRP03epyEl85B0mMfe8L2dpEw/ircfhxy2Wbr77tw99vbvIf9fTDYGsMwPgS0jM/YvObcN2xI"
        "X+Q8edJzHZTsTucDmNc+ICoffDHzVcyJU1cew2crDBxqkU3evhcgkhkc/ZLSrKzK6ywdlimXy92re7Xyly3Jof2b"
        "BasuA7y9B+ABLXXshav1CxB3A5iCJrBoObCMOYDqq9E3mtEQqdq/7/Bj1+n5Vs1dMMuWPGQBbV1tdU3ycAG3J6Nh"
        "o/D8FJ+6tEQl66D0qxZyIVM9P8I7oI6LxUQr+IDUN5fWNu4BZfcmruUYRPANRHRvn6XR1lKWpHdOqKlPGUjiZWOB"
        "6Y8chwPqlASlYix5/9KQejOiDwZVIwjD9RmUUwIIi5QDMNuuK2E9Xp1GUxLVA4Tcvry9kQKpbyQkJKAOTE395Z/y"
        "1+HhR9AEAvWiyZP9DH/9+XXa/Oq7ApcPSuio05OTk5HLq9bpO37C20NDV6AWoT60fXuY2a8/v85Z4P250VAfPMNg"
        "RE16jJINQkkqOPszspH36fqrtM8u5xOkY/IBgkJZUDa6hQsDiP0RVwzi7U/mPku95QUsoS9PqFVeIQkkAwMhiae/"
        "9la7taP2IzHw1/P3Z86cqUAcGhgYeP/Xn1+nlU3cNOG2L6mO/vd+tlzXXeDhhdb+sAjD+mpiYqJiHS104rfz69pg"
        "P41F/JMVXSXTGpkNEm2prcohCTM9YU0Y17YvuZzYzzHlL2P2U+D5mur1iiFEH5r/RvUj+xyZi6oekPC1lNhn09gz"
        "UmKfTaK/EHD/pa+j/z3/YO4jxeOn/+3f/YQrn/4t77Inn/VUL+c+XBr5SZZqhTlAuIbxhfXgmZPO2LvU+uu3khnL"
        "d0Tf18dsXRUImEECiFUtrviVcYKVj1Z/+rH5yGrtZIoG5sSp67tTPnBFQtj1xmLC8t6VcsLwQRRlaZqGsVY+Axqc"
        "hKtAJsOHGiEcVRWbUMEsjLgiCGBRPs+96jjrYqbmnboxLfGWYjj2fwAqeZvkog1Ne2pYhijrgJVNeCq7XtfrKtVV"
        "Ih4jQfk/nP/ci9jPpJiMmsnUfgSViwm7NSN/yb/3a+cSUPm0xOiwdi9M//7z+jNYR38e/I/6ozKj+nOM6E9d5S6q"
        "P12iLIWkPyQ/pr4Wc//WMJq/WXqR8isVKP+zYGxwyieA/emiQ2JSfkKuET3/O+Qvaf3nnhVWwtUf1/H9cX7jQFlk"
        "QRx73d0aHED/Bpu/JG8aStc3LVLELyIzxA38TlexFL6zdvhvExuRH1fSHTp8t5f5h6HFFaqvSAXtJUKSjjf1n/+Z"
        "erc5NRWPcPXUWTH5e7NHjZCtj2iQVhc8+XyeeUtXkzn2t7KZRivre2P4C5T6Alip2SD0yYtd2m0vZApoEalSpZEx"
        "Zn0TAclH3jLc25NvUKHauRhmdXyA5NTI6f5MtKIkIRjg/HLGIZfBqgFNOLRttA+Ow1eIWhKzCPOczAYyIdTi4TkB"
        "60/H/z6arHUJ6PxLLX+mtEqkj1IEk21gy6ePWVrv0kG9EqL4DH7ylNkpiSIFn0DdvzliXM7gRt6HeTO2ULbzIptS"
        "309zBIZq2AiarNoXxA/mCVU+jtqeWjaI2c8Kzp/d/S0rsP978SgFmqBokrkxLwDXMERzmtT4bs09PEWjb3W/S4dR"
        "531nKTgoWMC+5SLX1CaXmwtVPs4tptmL74CDU7jeY0g5739IUkK4f2x9LgytsAm5iXuY8IhKEsHbVR+ll0gM+mWO"
        "e0PA7cuqpf9i+fUJiYmJyZq3SZlVWeT1ete9RLrj3FWk9OkY0j8vVJD18p5107j4nZnndS3zn8OE0185yUn30PXR"
        "f3BnDm5FtPwz51JHMvzleD9r4bOUjzudvgWbNlDuXKCTb43QWW7qE6cj8Ixe9IvF+ylblOgYl0+odkKv2zoTVi8N"
        "fn76015O52+F3amlBTqoniu386K8O+vH59vgjOaT12tw/tAlrGKGDtBRSP7an+1wWtNyrJI9gZ/3YbFfJx8zPv0v"
        "dXk6D9IT5/PER9Ojc9F0AvO1Utj9MSrQadmpXLRAwTV/jtP7iJcfBaNkxHbXUzPOHhVs+A6ySTrSUOuyyBVbdMem"
        "S0lVKJ3lqPEH+2pPVF4f4HIQKs+5nnGBqPxC8Khl48mdlCfyaun0BBNpm9Ifs96kwW2ovlo2gWE3tQNMy2QclEDP"
        "npHEuQBoxM+pyRMW3kMFgssf5I0kDoPg1n+Bn84b0+AFAXauIsx7lEnRiL0e2sE0xHNjuBi2mXFQLIAx+t2jxh3e"
        "xvWtrM079hAv6ZUaty37Y0qWX0Jo5vl7aEmBa1k7CETzW+dkrVmzo5aZkCm3Jk6cOJ7VYJjnDC/jgGRKXMq9kdQF"
        "EtTji5edJquZAjLG4PSM5c5/O2LtOlxSlvoKaW87aX1Py+9vg7Z92LuADdKgvVz7Ujmx4IBrX9M1bPx+Fte+ZE2M"
        "34jnDG4z4y61/cQrUXkIKS/6GJW3nw9i60bm/bQvCZtx9nPcPy7dMv0ZGnDZZJ3+SiPRYT0XW8LRqfV7MM8F12Y3"
        "xJz3/R8/Wl/y1Cdyp0Yulr8ySbj5jUVUHq5RdPRSZKvj7+qEa3LV/8YOSmG3HoMQGl1bfEd3JwK6/AgkzTaUNba/"
        "K1s24cFKeOX2Mfo6XZ9x5y+boNO+VD9lM3PCowpfx7wobyBpfzVO5PyG2C/1SX3G336FgqtOSjD46rhw9Uems1uY"
        "Y8Oz5U7Vbbv3EtnoccGArHvrBBinmsTECwG3b95/7NLJNQNhq8oazjyOEeQNYvD9EWDF58zevJYMsCT851lrf0Ze"
        "4bqxw21VPiIXbHGcVDGpDShdLNcEQjfkL8ubOPt+hw0PyrXxXMr4J7KDtj1fG92GNcikB9nNcnVVYgXyd93U9vAG"
        "WnMxMw7AqIlFtAHXuBi/idlgJ3UvWIziNZhfnJfRl7wR8zamP13xAISDKiap6iNsj6dy8bsXitc55+3ybMScPsXN"
        "ROXf4uJ3D/R7+IPalSR/YCz9hXyCpL/QJOTQVYT954+qkmNUTGJe1fYkPp3NxaPSJsYzuXjeALGHygPewvHpqtoH"
        "4U2OND5VO9Jb0OUBEgHpD3SQEvvzgwIvQJVr6OievIneu1zn/euyg6qNh18iF+KSGSdcvvwDykD4cLbED03fsboT"
        "9w/ytiUjd7DVFwDDZgEkoOHYjj+k3Ykms8VMjAT1/F50cxHYT7dHtQzf5oiXWx5WFKe6/0L5nzIdXYW1p+jmxY43"
        "an3asPqItZ27DZNQL+3mqyV9eO6t4D5K+z6Ru9XqgX4NY2mdHwRpUIcVpCw5W4jn/0hM25J8LLTabsta2AeHADo/"
        "ZBlXeZUprD2EToicK85F7Qkmxr9KRvj0C5LIdCBYU9mW9xc15eRjyalPq48Y+hHolQWAZ+uM6B55ohGlJ+Fdfgjj"
        "fu/dwQWG8byH+M/VWVZH5ir5rMDw0miYVMr2UNYrfhOMKqe3We/QjNN4tHxyQo4l7AlHBfZ+M/0u3j5JdqOWDMjb"
        "FZfjEE8/dsOQMlfG712UwDtJbVd/zI2o/Vl3BMD+IUsR29dYw0a8n8KJ92QlWEB/y50dQ2q8qaTZsCXZ1CM4Qzf7"
        "kz+k+WgzYc0nN3DkDpSgmJCaeldD9guALy6Q/QRCsskCLu+HJHroVEQ3M1nTrFAoQgX1yPR9WFzJp/OZztENQ/au"
        "oGefJNOFwLWUjk/vSKLaYJSpE3seodaZs0+U/dPohkuSTdf/SG/ZfDFll8y2zSYz/mB7orOdzN6yIfSLt76l7J5P"
        "2aaB+nfifJ3df97Nof63kszGA7samiH1pMXbf0xnL+48Zde24w9bT31Aqyfsi25W3EGPqGcC5m7P7L/7+H/oYgPG"),
    0.45: (
        "eNrtnXdcFMcewOcKcHQQFRQFQzzsYECjiERELNgiiCLYUDGxINYENVaMRo1RsYuSjx1rJPZCAGtsWEBRj0gRTpR6"
        "9OMObt8u4Xbmt3n64ntRFp/zx/n5sjN7t7O/+bUpIvSxvN+iU/YJYF2q9T/K4qfNARtMagzYVtODV/0hthZbk9yT"
        "8qIkBLdRtFWQ1422GW/7Pxchf7FgFPmGy0U2WSyJwvcVbT72crO0loVT9iWERMeHNGVrLFyFNs5myWpoTMTQ2z96"
        "adk1uiguWnluL75/npWeUgejcCYynFynz29nDXnrYpLcTlepL7TE/ZG2xrLVrykCLbel6GsWc/XZ648TvtQj2zdY"
        "/rwwwo78i9D1ZEETLXSdSH/oKX207FI93sgytBoP6tFPNZrHQ8j2Ecvg75U2f6/dJQQk+iVlH90ZUdNque8hdMYV"
        "hcSJanncTyhiWJcM9nmbJ/om2z/zwDfoOL39yUWe04l3EHpu8NWQJLaH3dIahY9B97Q90jjdFS2YIXxqXssHZyLU"
        "7MqdJRw1UIfyZCgiyeRUqWIqwbMSDLuqTDB/exq1riS40fPtL8j69g+rVyMUqX3Hhs+/d8kf30ZpXMvdKnSRc+69"
        "SG11U5UfsjxPhbLtB2YWlx7o/WoEvqOFqE71M+SeQDsz+hleN/rwtbPAfSjghVnTQQ+UtwGXBzyEzYOPQp6/G/Ly"
        "iDdf57YfmATZuKIV/MPS51Ph7+817F12T0A3yAtyguEfXAs5Av2yC+T4EZBPfQ356Ow3X+e2z+4K0EUBtM3cl+D1"
        "oZFu71ecegEHTq/nka8JbYs6ZhS8ugus/8MUe5InD1ja6f/bH2rBsacrl76BWwcGno4ODGQdBM+dOx/c3bnT7e+2"
        "p4uX58cwBtuHRW2hPaiCBqPfkQ/reSVjAwMDmxDu4i/R0dHOH+Xgvy3GYW058al/3Rt4U8jjz0FO8IH2JBN6r3sX"
        "AGxcbAV43gHokGe4Ah5yH37ZhYkAWxUYAv5xHaxu8P49aQPgEUqvqVVpzXD0cT/OaRZ1keV2VE+0dwnVSMv9q3Ub"
        "X2xEsR6AdyWaP8KIcsPX9W/oNKJYC96GWrsU+VBslwqTqL6drl1GxBdUV11pAUTMkFcSb3M9mcQ+ubJ0ID1B49Jh"
        "g/+NG9nMzrRpzkZnKImii0bKow7R1yWpyXl1xRlzzCcuNWmXiF1gQWp32mVLhuP1DHCJheEFpIck3FHgDFDRmWy7"
        "o3KYjQ22WVIN0z/VZrxVmJlqusRitrK1HakcRNZwKAAqo8WLLeAGo5MKswdBFbS4lH0Fzf3oj88o1j9qXTVZx+5I"
        "BpYfv4xq9e/AZW2gz68e0olTmoCAKoVqQOAXeZ4km6X725O8fz8ieUTpwO7+1BBWoS2RyWTp1DMQ0rQB90eoZZUJ"
        "fw1uCCM/RIi59qCtrS1h8KJWwPpx50+dnUVkyGLODBidFgXreGjYDrBdS1uDThpWvxsUr5NYnb1FWMtkdeVvTcjW"
        "pjyTn1Z5IEWumxAJLq+RGZHYW1NV8Au2N0JZnFOHE4/ZDnOmaFVrUd0DmydbhEzU3Vn98/hwI/OIDKwCrX+rUF75"
        "FLicBnzqnRxGfv4gHDapVBp9FlSxKO8POFQGcpCi9BBw2acYDpe4DQAdqkG8i9af4NmIgv6PQ4JSeZV4f483SIz2"
        "xGNpUtGuTP9cfP3gDR//5E2YgzSyZxrsYH6qoftyjNpCy8PzmSSBuqeW7ZTTdHQXlWEXxzu1ojwRJDzM61h+jIB9"
        "/+x2deUJPP6N5JGW9td/w8NJTQtDD4p9XrdqWpV4aVgJ0U284DYg5Ti+n2WkrExhC9RvMQghdG7uAT9njozH2vmt"
        "i3XlaNjZSxzeqr3hd+0AN9MEflgBZg5n9iXU4+3aB8P5Uh2VO2C7RAHvu6BdZ+Aezy72IgPuuIdOBHoW/AjU2UjF"
        "WHizL1KjLWEEvzOHk78d1PfDER/TolK6DCce15Qur5+RMY6JpQvOEAo9POnSsP4+vzdk88wo6Oya75N7wSpDc74H"
        "7JxMKmCdxYppxJAxunUDTFc0/FbMsx4QNAAjPCRfUzgDo1e1j2SkxpHlqWvpgFYNM8QbnoAh9W0ucGj0K0aC2p/I"
        "gXeMGo7R5zjbn/JbZFyCF47G8+EGv14LC97yZLmWt2wVioxEFjdrh5SkwLh3cmbKwGG1Jr3beXTWWf/pEKuU2vRI"
        "FMoWoKNDjJ/XXr+IzraRPJ3f6WqtP5Bv73kne3Nimtbl3LlHLDRCun7aTpMczYucvCx5AytWQofAheNa1GH/RCjB"
        "hI1J2YPtJE981EtBemzX5wjTCBvfRmWJlhDx/+pLdnYeGnbBgji7vKysTB2m5cEKpiO+ytB64Ps313xnkStfpUdG"
        "hxfP1mMlIJ9oYt5PgWf85Mzal1M4ISSf297x6wo/zNmylKqnZqC+5d2tsP3y25gnGBh6pP7EchpFUVnb9fikgMyB"
        "utibS+Utxf1zJKm/+aBydorKUDWO/lz0VMtdqJr1X6zBcqOg99sVp2L/1Mdqxt7Pwwm2X+95GPYp/QFXOFSoKV5N"
        "uvTCRgJ+yU/hJWJGVz7DtnOYYg58/1vvQR6oFgHujlc51HAftRjwzETcfqqlnW/eUlJ+yu8s5a9TyIwvdQn+ffIp"
        "tra2TYn+Gg7ry8c1aEBm+OQauhx/Q30uT7S0tCRkLK0mv9qI3/2TRfz+mVKp1IZgzvzUXzg3PT2dyGDIl7q5ubX8"
        "++3ThvKuS4D+0YvMofKW4/EfleRl0id7LWvulYz+6bNSy50pGC10o8zRuPR0mYi4bmw/tlrM6i8m/pzxgG1w/L6H"
        "pEf2fOxPRBVqni+GDhqv5MeX/nAq1wX6woXSfy3PoMefN8FUTcE8Xl9f3/0N7TmcxpjCTmo9vo6vlACO/E94v5w2"
        "mtfOs76S0T+VOGC0tbOzG0DBkMDxLdkZD8Jxp+iPaXms/u+qmaDXK3kXrvtVTnXxATJeETQW8Wp80QHpgixLUn+u"
        "fNWBeN8BG1+QSwrkKVkg3JJTi6B8HFMFQX08rHIC1M8+NTqN0M+DS/rzVoBS/DjyP/Yd8ywbGxtLjn1/yd8BJlvC"
        "fPpUaN1geaklswqczTjLX4bTo+Ql5jkltnrp0zH7bPt52jUpwc1K8zxIRov2I8B0wZxaM/faQm3K1/5hbOvEePx+"
        "VQ60wsATePI/bosBj037BrBP7zIpYLQjfjpg06z7gNFACnMa0z+7r/Ip/gIRk2RXviaFmGA/9MTJZCSOP/Vq5r52"
        "HtayU43qnZKG/R/mbmNfYdXM+N7B6az+r2QWs57HDvbph73NJ6rH4wTj8RKNfC75i4QWPPOflQ9CifgixMo2sCgY"
        "6o/IU5B/xxkQ+YXwrcmvOmKOXrxghNVb2PdRfBtR/0Z+grjy48uRn0NvKT+pHPnZyJGfLkB+sqsdoPws28En+Sk5"
        "QdgYebDVJ0GqdjBeP78WsOQFDvjld46fK75C+Ac7g1ZUEHvgmPrx2yB/psLyVuM/bznJI/mB88suiVVVV3B36CrC"
        "raTHMtj0hJSir5nNY5coCBLve4P2ZsvSFTvB8i9B1+MKdgl1p0lMErGUXUHvqPnKqNFMCqech6ZUVaeCBZBGxjzq"
        "rL3qGv+ZVYlN2rcvmN2+LZmPyeVkKP5plnvzOcAoYJYOeLL6AymZ2ZtBpf81lzB73XwLWb7GJJi3X2J5UY5/A/88"
        "HL8L1+dReevAgpCGPMqWfRfDfPrLsPwzQ+NsOFsheQ79g1UuLC+8g9CkVPwEUo09iv+BuOPtRdbVjgTPSp75iPxG"
        "6+oXC8FPOF/Zkr/iMybhz39X12bgO1f/Ofqvz6u1Xyo3tPIOEpX1qW1wdzp6VmXXntJGtDt2dZDvnzGGNWiTExds"
        "8o4NP6blz9WJPQ0USazASFQ5InSEwlPKN2kB81XydUY1UE77KpK77BJwYfwZAVqTjBOotoqp7mACaHR5Jnj/woxy"
        "4DDMzUkjF3A6VQ7spsbrNw0eb0JocQ7rIC1/QH+V6FIUX+Vn7jVm6C9m4wvjF7S/0rLiCyxgeRboNPHzBdcjvixp"
        "Rtyhk/rlPHDLPc9hsmvxNfRGnhfPY/U8vMZ+VbAmW2JnZyd9FAfqhOWT/YHcq4A5bpgFtmAKTj4C679mVJDKCHVU"
        "rqLjd7w+/Nua7KOmNV/6w7S47BLJFlRbU8hQE7x/bg6Wt5lT1G2Y0DPQ/Sf7w4izPGLdWshtCzir/WKDIA+9C1mc"
        "ydmvuXAfZKsSeIIEioLDD7llcBKED76E/NUpTkD0Hh3GbWWlYHeWkVVOd1jjZZ2y2ADyLorqCq+/69WbdmA5Mxr1"
        "MoGcT9FfYurpiz4WvpSmq/4sU17D77tIguBuc8GCzKawRjfpx7f2FsX+58u7COsrfrGiy6ZMbEIELZDAgSJOGBgY"
        "nX6Fwia9Q143oQ3Bk+9LBD8RbHo299W2SnKCxLRul4dbweBPQsHTEwyodhwesefibCHBGYETcuYRPAyh4BSC6Wft"
        "oSKYjn99XxF82sQ0Hm/J1FNtKFTdAv6V2Lw+yY/F6thDxG524b0Yn+UqbAI7aj6hPWAcTflnwea9Kmhz4IDXOxiU"
        "ztVpV0zkVHumlVZuBgbfQlLXz2zIWdG/6jDkH4n9gU13xIZtxCxKPjdkdRXm7lVmCJ3GPDKDCXYx9y+hZW83ZouS"
        "YJFzEXH/YYXlssPkFl9+pef/s8O9IiacUOmCq3u6zs/AHmCHCloXXcXTEaMr7927V4Cd0M6KhhYWFkRA9mA8sj5B"
        "rDbsdjK9aB1wYs106vSBW0+bRKJN0ZEZJPs9A7UX3Sk4Op/gHttTA8CBIeOh+//WPOp6/bZf1jtil/nhdLzo0Tnv"
        "VZV4OsuFGV9nMfsx42slZs8yWrfswWxS8J1hr3JivVm/Z6qbv2A2nyQUod3rcf3cdZ/75/ckAqLd1w8MeZ/2qyPH"
        "Xjlx2H/3hTkCglOD5+QSy5uoqQj9cJtgWnf75sD7DX0966nbIzQ4izfiIHKC4W9LihMOcZK/ulFQXRpT0n+UDdQt"
        "+DVeHKHt0uHuv2rACfi3QX8I5Xq9UxaVuZDYPeYZOE2hg3/jd+0fcuIN6lPOeJL+hQcdMCA5NM+TvB4jawXqU76w"
        "/cpSL3i/gFIin6GnaoG8i9z4Iz9/0T/2nP5o/V5ZT83z3Sn/oehGDTlxuHPHvSf6a/XHrcGR+UnD5le0q+VeSFw+"
        "C6GbU7F+YdZ8HllB8NDXco3+eTgYof1L6mn/uO0+P1NA6FfZlG/zZxI8EaE1lwmm7dGIdILpfvR7PRuoafn1ltVf"
        "ATJfHhNB7IcU3rz45YpiHH87aOj3fxXPDw5n9jWtjGbZo5yOv6J24v4onqfjWEocaNcjpbgA7q8zF9aj7hEfcN8b"
        "Eyoi9EfauAk5i0n/iI7fn8H4v4ea4C9ofyiX4BPGpvGHCN5eoLrVnGwP4nduPkEYzLPd4M0jY1f44QMSxE8ueK9W"
        "4fjStboBQsR5NyMYV28l5n6M/xxBxKel00WO+UR86ldY/vTkURifruQcKcnlz/vwSP+4b/kG+HepKwYA9uX4f+3e"
        "imv0T30ubgdiw4iMfhNlkPMxYv7YSfU5rL8w949VwMfScT2TgMlzkwEKycRsdDgvTT4QWPy6nYrX5xzVFMpZujXv"
        "NIzfk7KPjifj94P3Ajq+of5fOJRzGJxfdkuQv5AcJ6PVeldMD9L6sB8+wa45ZY3QnCt/m82YeDUcM0qJMHZ4QbBr"
        "pjJr928gf1if+mcMM9ESgJez9s2XIEEK3lMiTB2B3AuI/XLzL6C94aS/rnQsAyrnqAwudvZQ+9dj+fGh+2fAPDpQ"
        "rN2B3Pe5AF0oM0A/16YIdYsczRVXvYXZ7rUNDn836tikvZ3ztWHuyN+PjbTKW84eQG+uVJiiy6X4yOJztLM0udi4"
        "nvZP3/UipLMFT/EaPwlDa28QOZIOpevzwHE2yyhwnFvTlzceEfpdfHmfOI5YLvPNfUNkmRlQb+VnNHMw/VC8XbdX"
        "sQkSyrDGFjyairxyiBmHyQ8Fp0l/2EgRpARH0K6rhIuhnCkXqNBvQQc1Ax7HYDRVl0/90+UoXYgjbZoGBEws2wSq"
        "RCWACZmZ+eB/HHGvBAmeZq/CxGJiOmcOs/ynUsKjJw55CnY0ta3sD+ztlIuw+qKDkA+sAuhbDPOx4xScfNrxNZCX"
        "cJbSBXPsv1M55/Tf7ws4o0/wv8RnOnNhazNK74Niyb53u7tw2014+LvZslSYMDNgAnKylHCOU/+Ds2F0frYN4LEK"
        "uALiLjywFxXB05F04fEtOjNegBe8Ox1uLaxPsX1NGb9xstMInJM1iw07nnWzWR39mH8B0rwpHA=="),
}


@functools.lru_cache(maxsize=None)
def coverage(scale: float) -> np.ndarray:
    """The [95, rows, columns] uint8 coverage maps at ``scale`` (0.4 or
    0.45), read only."""
    if scale not in _ENCODED:
        raise ValueError(f"glyphs are recorded at scales {sorted(_ENCODED)}, not {scale}")
    maps = np.frombuffer(zlib.decompress(base64.b64decode("".join(_ENCODED[scale]))),
                         np.uint8).reshape((NUM_CHARS,) + BOX)
    maps.flags.writeable = False
    return maps
